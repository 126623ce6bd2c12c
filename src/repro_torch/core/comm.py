"""Quantized flat-buffer communication over ``core.flatten.FlatLayout``.

The port of ``repro.core.comm``.  The packed ``(n_flat,)`` vector of a model is the unit
of both directions of the protocol:

* **broadcast** (server -> client): the server's flat vector is encoded to
  the wire dtype and the client trains on the decoded copy;
* **upload** (client -> server): each trained chunk goes through the same
  wire format, and the fold dequantizes inside its accumulate (K2,
  ``masked_agg_acc_deq_``), so no f32 copy of the int8 uploads exists.

Wire formats (``WireSpec.dtype``): ``float32`` (identity), ``bfloat16``
(2-byte payload), ``int8`` (symmetric per-group ``q = round(x / s)``,
``s = max|x| / 127`` per ``quant_block`` elements, plus an f32 scale
sidecar).  ``quant_block`` divides the lane alignment (128), so a scale
group never crosses a leaf slot.

**Wire v2** rides the upload only: ``topk_frac < 1`` ships the ``k``
largest-|d| entries of the delta ``d = y - x`` as index + value payloads;
``stochastic`` rounds the lossy encode with random bits; ``error_feedback``
carries each client's compression residual into its next upload.

**Random bits.**  The reference draws stochastic-rounding bits from
threefry keys that PyTorch cannot reproduce, so the encoders take a bit
source: ``bits(shape) -> int64 tensor`` holding uint32 values, called with
the same shapes the reference draws (``(groups, quant_block)`` for int8,
the payload's shape for bf16).  The trainer binds it per client from a
provider (``federated.SeededBits`` by default); tests fill it with the
reference's own bits.  The arithmetic then matches the reference's
bitwise: ``u = bits * 2**-32`` rounds the uint32 to f32 to nearest (as
``astype(float32)`` does), and the bf16 rounding adds the low 16 bits to
the f32 pattern in 64-bit integers, masked back to 32.

Byte accounting is measured: :func:`wire_bytes` and :func:`wire_bytes_up`
run the real encoders on ``meta`` tensors (shapes only) and sum the output
buffers, for the true element counts; alignment padding is never billed.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence

import torch

from repro_torch.core import flatten
from repro_torch.tree import Tree

WIRE_DTYPES = ("float32", "bfloat16", "int8")

# int8 symmetric range: +-127 (-128 unused, keeps the code symmetric)
_QMAX = 127.0
# XLA rewrites the reference's ``max|g| / 127`` into a multiplication by
# the f32 reciprocal of 127 inside every jitted program, its round
# included, so the scales its clients and server see are ``max|g| *
# f32(1/127)``; the port multiplies the same way and matches them bit for
# bit (the eager reference differs from both by an ulp now and then)
_INV_QMAX = torch.tensor(1.0 / _QMAX, dtype=torch.float32).item()

# ``bits(shape)``: uniform uint32 values (in an int64 tensor) of that shape
BitSource = Callable[[Sequence[int]], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class WireSpec:
    """Static description of the wire format for one federated link (see
    ``repro.core.comm.WireSpec``): payload dtype, int8 scale-group size,
    and the upload knobs ``topk_frac``, ``stochastic`` and
    ``error_feedback``.  Any of the three moves uploads to delta space."""
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
    def is_quantized(self) -> bool:
        return self.dtype == "int8"

    @property
    def is_sparse(self) -> bool:
        """True when uploads ship top-k index+value payloads."""
        return self.topk_frac < 1.0

    @property
    def uses_deltas(self) -> bool:
        """True when uploads are deltas against the broadcast."""
        return self.is_sparse or self.stochastic or self.error_feedback

    @property
    def payload_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


class WireBuffer(NamedTuple):
    """One encoded flat buffer: payload in the wire dtype (+ the f32 scale
    sidecar for int8, else ``None``)."""
    payload: torch.Tensor
    scales: Optional[torch.Tensor]


class SparseWireBuffer(NamedTuple):
    """One top-k encoded flat buffer: the ``k`` kept values in the wire
    dtype (+ the f32 scale sidecar over the compacted payload for int8),
    and their sorted int32 flat positions."""
    payload: torch.Tensor
    scales: Optional[torch.Tensor]
    indices: torch.Tensor


def buffer_nbytes(buf: WireBuffer) -> int:
    """Measured wire size of one encoded buffer (payload + sidecar)."""
    n = buf.payload.numel() * buf.payload.element_size()
    if buf.scales is not None:
        n += buf.scales.numel() * buf.scales.element_size()
    return int(n)


def sparse_buffer_nbytes(buf: SparseWireBuffer) -> int:
    """Measured wire size of one sparse upload: values + scale sidecar +
    int32 indices."""
    n = buffer_nbytes(WireBuffer(buf.payload, buf.scales))
    return n + int(buf.indices.numel() * buf.indices.element_size())


# ---------------------------------------------------------------------------
# Stochastic rounding (the reference's arithmetic on uint32 bits)
# ---------------------------------------------------------------------------

def stochastic_round_int(v: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """``floor(v + u)`` with ``u = bits * 2**-32`` in [0, 1], clipped to
    +-127.  ``bits`` holds uint32 values (int64); the conversion to f32
    rounds to nearest, as the reference's does, so bits near 2**32 give
    u = 1.0 in both."""
    u = bits.to(torch.float32) * (2.0 ** -32)
    return torch.clamp(torch.floor(v + u), -_QMAX, _QMAX)


def stochastic_round_bf16(x: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Stochastic f32 -> bf16: add the low 16 random bits to the f32 bit
    pattern and truncate the mantissa (uint32 arithmetic, carried out in
    int64 and masked back to 32 bits)."""
    u = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    u = ((u & 0xFFFFFFFF) + (bits & 0xFFFF)) & 0xFFFF0000
    u = torch.where(u >= 2**31, u - 2**32, u).to(torch.int32)
    return u.view(torch.float32).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# Quantize / dequantize (symmetric per-group int8)
# ---------------------------------------------------------------------------

def quantize(x: torch.Tensor, quant_block: int, *,
             bits: Optional[BitSource] = None):
    """Symmetric per-group int8 quantization of ``x`` (``(..., n)``, ``n``
    a multiple of ``quant_block``; cast to f32).  ``bits`` switches
    round-to-nearest-even to :func:`stochastic_round_int`.

    Returns ``(q, scales)``: int8 of ``x``'s shape and f32 ``(...,
    n / quant_block)``.  All-zero groups get scale 0 and payload 0; a
    non-finite input gives a non-finite scale (the fold's weight gate
    drops such clients)."""
    n = x.shape[-1]
    if n % quant_block:
        raise ValueError(f"length {n} not a multiple of "
                         f"quant_block={quant_block}")
    g = x.to(torch.float32).reshape(x.shape[:-1] + (-1, quant_block))
    scales = torch.amax(torch.abs(g), dim=-1) * _INV_QMAX
    v = g / scales[..., None].clamp_min(1e-30)
    del g
    # in place on v: one f32 temporary of x's size (a packed LM client is
    # 10 GB), the values those of round / where / clamp out of place
    if bits is None:
        v.round_()
    else:
        v = stochastic_round_int(v, bits(tuple(v.shape)).to(v.device))
    v.masked_fill_(~(scales[..., None] > 0), 0.0)
    q = v.clamp_(-_QMAX, _QMAX).to(torch.int8)
    return q.reshape(x.shape), scales


def dequantize(q: torch.Tensor, scales: torch.Tensor,
               quant_block: int) -> torch.Tensor:
    """Inverse of :func:`quantize`: f32 ``q * scale`` per group."""
    g = q.to(torch.float32).reshape(q.shape[:-1] + (-1, quant_block))
    return (g * scales[..., None]).reshape(q.shape)


# ---------------------------------------------------------------------------
# Encode / decode
# ---------------------------------------------------------------------------

def _pad_last(x: torch.Tensor, pad: int) -> torch.Tensor:
    if not pad:
        return x
    return torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)


def encode(spec: WireSpec, flat: torch.Tensor, *,
           bits: Optional[BitSource] = None) -> WireBuffer:
    """Encode ``(..., n)`` f32 values for the wire.  ``bits`` is used only
    when ``spec.stochastic`` (broadcasts never pass one).  int8 lengths
    that are not a group multiple are zero-padded into the last group; the
    payload keeps the caller's length."""
    bits = bits if spec.stochastic else None
    if spec.is_quantized:
        n = flat.shape[-1]
        body = _pad_last(flat.to(torch.float32), (-n) % spec.quant_block)
        q, scales = quantize(body, spec.quant_block, bits=bits)
        return WireBuffer(q[..., :n], scales)
    if spec.dtype == "bfloat16" and bits is not None:
        draw = bits(tuple(flat.shape)).to(flat.device)
        return WireBuffer(stochastic_round_bf16(flat, draw), None)
    return WireBuffer(flat.to(spec.payload_dtype), None)


def decode(spec: WireSpec, buf: WireBuffer) -> torch.Tensor:
    """Decode a wire buffer back to f32 values of the payload's length."""
    if spec.is_quantized:
        n = buf.payload.shape[-1]
        q = _pad_last(buf.payload, (-n) % spec.quant_block)
        return dequantize(q, buf.scales, spec.quant_block)[..., :n]
    return buf.payload.to(torch.float32)


# ---------------------------------------------------------------------------
# Top-k sparse encode / decode (wire v2 uploads)
# ---------------------------------------------------------------------------

def topk_count(spec: WireSpec, n_elements: int) -> int:
    """Entries a sparse upload of ``n_elements`` true elements keeps:
    ``ceil(n * topk_frac)`` rounded up to a lane multiple (128).  Dense
    specs keep everything."""
    if not spec.is_sparse:
        return int(n_elements)
    k = max(1, math.ceil(n_elements * spec.topk_frac))
    return -(-k // flatten.LANES) * flatten.LANES


def topk_indices(flat: torch.Tensor, k: int) -> torch.Tensor:
    """Sorted int32 positions of the ``k`` largest ``|flat|``, ties broken
    toward the lower index as ``jax.lax.top_k`` breaks them (a stable
    descending sort; ``torch.topk`` promises no order among ties, and a
    small model's ``k`` often reaches into the exact zeros)."""
    order = torch.sort(torch.abs(flat), descending=True, stable=True).indices
    return torch.sort(order[:k]).values.to(torch.int32)


def sparse_encode(spec: WireSpec, flat: torch.Tensor, k: int, *,
                  bits: Optional[BitSource] = None) -> SparseWireBuffer:
    """Top-k encode one ``(n,)`` vector: the ``k`` largest-|x| entries
    (``k`` a ``quant_block`` multiple, ``<= n``), encoded through the dense
    wire encoder (int8 scale groups over the compacted payload), with
    their sorted int32 positions."""
    flat = flat.to(torch.float32)
    idx = topk_indices(flat, k)
    dense = encode(spec, flat[idx.to(torch.int64)], bits=bits)
    return SparseWireBuffer(dense.payload, dense.scales, idx)


def sparse_decode_values(spec: WireSpec, buf: SparseWireBuffer
                         ) -> torch.Tensor:
    """Decode only the compacted ``(k,)`` values of a sparse buffer."""
    return decode(spec, WireBuffer(buf.payload, buf.scales))


def sparse_decode(spec: WireSpec, buf: SparseWireBuffer,
                  n: int) -> torch.Tensor:
    """The decoded values scattered into an ``(n,)`` f32 zero vector."""
    vals = sparse_decode_values(spec, buf)
    out = torch.zeros((n,), dtype=torch.float32, device=vals.device)
    return out.index_add_(0, buf.indices.to(torch.int64), vals)


# ---------------------------------------------------------------------------
# Measured byte accounting
# ---------------------------------------------------------------------------

def _probe(n: int) -> torch.Tensor:
    return torch.empty((n,), dtype=torch.float32, device="meta")


@functools.lru_cache(maxsize=None)
def wire_bytes(spec: WireSpec, n_elements: int) -> int:
    """Measured wire size of an ``n_elements`` exchange: the encoder's
    output on a ``meta`` tensor (no compute), payload + scale sidecar."""
    return buffer_nbytes(encode(spec, _probe(n_elements)))


def analytic_wire_bytes(spec: WireSpec, n_elements: int) -> int:
    """Closed form the measured number must match: ``n * itemsize`` plus
    ``ceil(n / quant_block) * 4`` for int8."""
    n = n_elements * torch.empty((), dtype=spec.payload_dtype).element_size()
    if spec.is_quantized:
        n += (-(-n_elements // spec.quant_block)) * 4
    return n


@functools.lru_cache(maxsize=None)
def wire_bytes_up(spec: WireSpec, n_elements: int) -> int:
    """Measured size of one upload of ``n_elements`` true elements: dense
    wires bill :func:`wire_bytes`; sparse wires run the top-k encoder on a
    ``meta`` vector (values + sidecar + int32 indices for
    ``topk_count`` entries)."""
    if not spec.is_sparse:
        return wire_bytes(spec, n_elements)
    k = topk_count(spec, n_elements)
    n_vec = max(-(-n_elements // flatten.LANES) * flatten.LANES, k)
    return sparse_buffer_nbytes(sparse_encode(spec, _probe(n_vec), k))


def analytic_wire_bytes_up(spec: WireSpec, n_elements: int) -> int:
    """Closed-form upload size: ``k * itemsize`` values + ``k /
    quant_block * 4`` scales (int8) + ``k * 4`` indices."""
    if not spec.is_sparse:
        return analytic_wire_bytes(spec, n_elements)
    k = topk_count(spec, n_elements)
    n = k * torch.empty((), dtype=spec.payload_dtype).element_size() + k * 4
    if spec.is_quantized:
        n += (k // spec.quant_block) * 4
    return n


class VersionCache:
    """Version-tagged download accounting for the async broadcast, as a
    per-client host dict: the reference semantics that the async engine's
    vectorized billing (``ClientStateMatrix.bill_downloads`` over the
    ``version_tag`` column) is held to.

    * ``bill(client_id, tag, nbytes)`` — returns ``nbytes`` and records
      the fetch if the client's cached tag differs, else returns 0;
    * ``holds(client_id, tag)`` — query without billing.

    Tags are opaque hashables (the engine uses the publishing round
    index).  ``hits`` / ``misses`` count ``bill`` outcomes since
    construction: a hit is a reused stale broadcast."""

    def __init__(self):
        self._held: Dict[Any, Any] = {}
        self.hits = 0
        self.misses = 0

    def holds(self, client_id, tag) -> bool:
        """True when ``client_id`` already fetched version ``tag``."""
        return self._held.get(client_id) == tag

    def bill(self, client_id, tag, nbytes: int) -> int:
        """Bytes this client's download of version ``tag`` costs now:
        ``nbytes`` on a cache miss (recorded), 0 on a hit."""
        if self.holds(client_id, tag):
            self.hits += 1
            return 0
        self.misses += 1
        self._held[client_id] = tag
        return int(nbytes)


# ---------------------------------------------------------------------------
# Tree-level paths
# ---------------------------------------------------------------------------

def encode_tree(spec: WireSpec, layout: flatten.FlatLayout,
                tree: Tree) -> WireBuffer:
    """Pack a parameter tree through ``layout`` and encode the flat
    vector (one contiguous buffer per model)."""
    return encode(spec, flatten.pack(layout, tree))


def decode_tree(spec: WireSpec, layout: flatten.FlatLayout,
                buf: WireBuffer) -> Tree:
    """Decode a wire buffer and unpack it to the layout's tree."""
    return flatten.unpack(layout, decode(spec, buf))


def broadcast_roundtrip(spec: WireSpec, layout: flatten.FlatLayout,
                        tree: Tree) -> Tree:
    """What a client receives: the server tree after one encode/decode
    trip through the wire (the tree itself on the f32 wire)."""
    if spec.is_identity:
        return tree
    return decode_tree(spec, layout, encode_tree(spec, layout, tree))
