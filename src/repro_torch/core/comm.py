"""Communication wire: the f32 identity wire only.

The port of the parts of ``repro.core.comm`` that the synchronous round on
the float32 wire runs: :class:`WireSpec` (with all of the reference's
validation rules, so configs are judged alike), a measured
:func:`wire_bytes` and an identity :func:`broadcast_roundtrip`.  The int8
and bf16 wires and the wire-v2 uploads are not ported yet: they raise.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core import flatten
from repro_torch.tree import Tree

WIRE_DTYPES = ("float32", "bfloat16", "int8")


@dataclasses.dataclass(frozen=True)
class WireSpec:
    """Static description of the wire format for one federated link (see
    ``repro.core.comm.WireSpec``)."""
    dtype: str = "float32"
    quant_block: int = 128
    topk_frac: float = 1.0
    stochastic: bool = False
    error_feedback: bool = False

    def __post_init__(self):
        if self.dtype not in WIRE_DTYPES:
            raise ValueError(f"wire dtype must be one of {WIRE_DTYPES}, "
                             f"got {self.dtype!r}")
        if self.quant_block <= 0 or flatten.LANES % self.quant_block:
            raise ValueError(f"quant_block must divide the lane alignment "
                             f"({flatten.LANES}), got {self.quant_block}")
        if not 0.0 < self.topk_frac <= 1.0:
            raise ValueError(f"topk_frac must be in (0, 1], got "
                             f"{self.topk_frac}")
        if self.stochastic and self.dtype == "float32":
            raise ValueError("stochastic rounding requires a lossy wire "
                             "dtype (bfloat16 or int8), not float32")
        if self.error_feedback and self.dtype == "float32" \
                and self.topk_frac == 1.0:
            raise ValueError(
                "error_feedback requires a lossy upload path (bfloat16/"
                "int8 wire or topk_frac < 1); on the dense float32 wire "
                "the residual is identically zero")

    @property
    def is_identity(self) -> bool:
        return self.dtype == "float32"

    @property
    def is_sparse(self) -> bool:
        return self.topk_frac < 1.0

    @property
    def uses_deltas(self) -> bool:
        return self.is_sparse or self.stochastic or self.error_feedback


class WireBuffer(NamedTuple):
    """One encoded flat buffer: payload (+ scale sidecar, int8 only)."""
    payload: torch.Tensor
    scales: Optional[torch.Tensor]


def _require_identity(spec: WireSpec) -> None:
    if not spec.is_identity or spec.uses_deltas:
        raise NotImplementedError(
            f"wire {spec} is not ported to repro_torch yet; only the "
            f"dense float32 wire is")


def encode(spec: WireSpec, flat: torch.Tensor) -> WireBuffer:
    """Encode one flat vector for the wire (f32: the vector itself)."""
    _require_identity(spec)
    return WireBuffer(flat.to(torch.float32), None)


def buffer_nbytes(buf: WireBuffer) -> int:
    """Measured wire size of one encoded buffer (payload + sidecar)."""
    n = buf.payload.numel() * buf.payload.element_size()
    if buf.scales is not None:
        n += buf.scales.numel() * buf.scales.element_size()
    return int(n)


def wire_bytes(spec: WireSpec, n_elements: int) -> int:
    """Measured wire size of an ``n_elements`` exchange: the encoder's real
    output on a ``meta`` tensor (shapes only, no compute) — ``4 * n`` on
    the f32 wire."""
    probe = torch.empty((n_elements,), dtype=torch.float32, device="meta")
    return buffer_nbytes(encode(spec, probe))


def broadcast_roundtrip(spec: WireSpec, layout: flatten.FlatLayout,
                        tree: Tree) -> Tree:
    """What a client receives: the server tree after one trip through the
    wire — the tree itself on the f32 wire."""
    _require_identity(spec)
    return tree
