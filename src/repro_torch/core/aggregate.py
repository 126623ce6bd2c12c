"""Server aggregation — FedHeN Alg. 1 ln. 16-22, plus NoSide and Decouple.

The port of ``repro.core.aggregate``'s flat streaming engine over the dense
f32/bf16 stream (the production fold).  :class:`StreamState` carries one
flat f32 accumulator of *unnormalized* masked sums (plus a second one for
decouple).  Each trained chunk arrives packed in one contiguous
``(Z, n_flat)`` buffer and is folded with ONE ``masked_agg_acc_`` launch
that updates the accumulator in place (two for decouple).  Normalization
and unpacking happen once, at :func:`streaming_finalize`.

**Weight contract** (the reference's): ``valid`` is a per-client
coefficient; a weight of 0 gates the client's values before the multiply
(a NaN device at weight 0 can never poison the sums).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import flatten
from repro_torch.kernels.masked_agg.ops import masked_agg_acc_
from repro_torch.tree import Tree

ALGORITHMS = ("fedhen", "noside", "decouple")


def _chunk_weights(is_simple: torch.Tensor, valid: torch.Tensor,
                   algorithm: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw (unnormalized) per-client weights of one chunk.

    ``w_in`` weights the inside-M accumulator: every valid device for
    fedhen/noside (Alg. 1 ln. 18), simple devices only for decouple.
    ``w_out`` weights outside M: complex devices only (ln. 22)."""
    if algorithm not in ALGORITHMS:
        raise ValueError(algorithm)
    valid_f = valid.to(torch.float32)
    w_in = valid_f * is_simple if algorithm == "decouple" else valid_f
    w_out = valid_f * (~is_simple)
    return w_in, w_out


def _safe_inv(tot: torch.Tensor) -> torch.Tensor:
    """1/tot with the zero-weight-group guard (0 -> 0, never NaN)."""
    return torch.where(tot > 0, 1.0 / torch.clamp(tot, min=1e-12),
                       torch.zeros_like(tot))


class StreamState(NamedTuple):
    """Running sums of one round's chunked aggregation.

    ``acc``: flat f32 sums — inside M ``sum_z w_in[z] x[z]``, outside M
    ``sum_z w_out[z] x[z]``.  ``acc_out`` (decouple only, else ``None``):
    the whole-vector ``w_out`` sums.  ``tot_in`` / ``tot_out``: the 0-d
    weight totals finalize divides by.  All on the round's device; the
    fold updates ``acc``/``acc_out`` in place."""
    acc: torch.Tensor
    acc_out: Optional[torch.Tensor]
    tot_in: torch.Tensor
    tot_out: torch.Tensor


def streaming_init(layout: flatten.FlatLayout, algorithm: str,
                   device) -> StreamState:
    """Zero accumulators for one round (``(n_flat,)`` f32 each)."""
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    acc_out = zeros(layout.n_flat) if algorithm == "decouple" else None
    return StreamState(zeros(layout.n_flat), acc_out, zeros(), zeros())


def streaming_fold(state: StreamState, xz: torch.Tensor,
                   flat_mask: torch.Tensor, is_simple: torch.Tensor,
                   valid: torch.Tensor, algorithm: str) -> StreamState:
    """Fold one packed chunk ``xz`` (``(Z, n_flat)``, f32 or bf16) into the
    sums: one in-place ``masked_agg_acc_`` launch, two for decouple (its
    second accumulator uses ``w_out`` on both mask branches).

    ``is_simple`` (Z,) bool; ``valid`` (Z,) bool or f32 weights."""
    w_in, w_out = _chunk_weights(is_simple, valid, algorithm)
    masked_agg_acc_(state.acc, xz, flat_mask, w_in, w_out)
    if state.acc_out is not None:
        masked_agg_acc_(state.acc_out, xz, flat_mask, w_out, w_out)
    return StreamState(state.acc, state.acc_out,
                       state.tot_in + w_in.sum(), state.tot_out + w_out.sum())


def streaming_finalize(state: StreamState, layout: flatten.FlatLayout,
                       flat_mask: torch.Tensor, algorithm: str
                       ) -> Tuple[Tree, Optional[Tree]]:
    """Normalize the flat sums and unpack them to parameter trees.

    Returns ``(new_complex, new_simple_host)``; the host is ``None`` except
    for decouple, whose new complex model is ``acc_out / tot_out`` and
    whose simple host is the combined vector.  A group with zero total
    weight yields zeros."""
    inv_in, inv_out = _safe_inv(state.tot_in), _safe_inv(state.tot_out)
    combined = flatten.unpack(
        layout, state.acc * torch.where(flat_mask, inv_in, inv_out))
    if algorithm == "decouple":
        return flatten.unpack(layout, state.acc_out * inv_out), combined
    return combined, None
