"""Wrappers of the masked fold kernels (``csrc/*.cu``).

Each replaces one function of the reference's
``repro.kernels.masked_agg.kernel``.  K4 (``masked_agg_pallas``) is one
kernel over a table of leaves, with two entry points:

* ``masked_agg_fold_``: the tree engine's fold.  Every leaf of a packed
  layout (a :class:`FoldPlan`, built once per layout and kept on the
  device) is folded from the packed ``(Z, n_flat)`` chunk buffer into the
  f32 accumulator in place, ``acc += masked sum``, in ONE launch;
* ``masked_agg_``: the one-shot fold of one leaf, a dense f32/bf16
  ``(Z, N)`` chunk whose rows may lie ``ld`` elements apart, summed into a
  new ``(N,)`` in ``x``'s dtype (``masked_agg_leaf`` / ``masked_agg_tree``
  call it once per leaf).

The other folds update the f32 accumulator in place:

* ``masked_agg_acc_`` (K1, ``masked_agg_acc_pallas``): a dense f32/bf16
  ``(Z, N)`` chunk;
* ``masked_agg_acc_deq_`` (K2, ``masked_agg_acc_deq_pallas``): an int8
  ``(Z, N)`` payload with per-group f32 scales, dequantized in registers;
* ``masked_scatter_acc_`` (K3, ``masked_scatter_acc_pallas``): top-k
  ``(Z, k)`` payloads scattered at their int32 indices (two launches: the
  rows' segment bounds per span, then the fold).

On CPU tensors each runs its plain version (``ref.py``); on CUDA tensors it
launches its kernel or raises — there is no fallback.  On ``meta`` tensors
(the dry-runs) it returns its result's shape and dtype and computes
nothing: a ``meta`` tensor has no values for any implementation to fold.
Each wrapper's ``launches`` counts its kernel launches (never
plain-version calls), so a run can show that its folds went through the
kernels; and each reports its work, whatever the device, to an active
roofline walk (``kernels/work.py``): the flops of its gated
multiply-adds and the bytes of its operands and results.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build, work
from repro_torch.kernels.masked_agg.ref import (masked_agg_acc_deq_ref,
                                                masked_agg_acc_ref,
                                                masked_agg_fold_ref,
                                                masked_agg_ref,
                                                masked_scatter_acc_ref)
from repro_torch.tree import Tree, tree_map

_X_DTYPES = (torch.float32, torch.bfloat16)
# value kinds of the scatter kernel's C interface
_VALUE_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MAX_SCATTER_ROWS = 6144     # a K3 block keeps 8 bytes of every row in
                             # shared memory
TILE = 512                   # elements of one K4 work item (kTile)
SCATTER_STAGE = 2048         # entries a K3 block stages at once (kStage)
SCATTER_SPAN = (1024, 4096)  # least and most acc positions of a K3 block
_DEVICES = ("cpu", "cuda", "meta")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load()
    ptr = ctypes.c_void_p
    lib.masked_agg_acc.argtypes = [ptr, ptr, ptr, ptr, ptr, ctypes.c_int64,
                                   ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                   ptr]
    lib.masked_agg_acc.restype = ctypes.c_int
    lib.masked_agg_acc_deq.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr,
                                       ctypes.c_int64, ctypes.c_int64,
                                       ctypes.c_int, ctypes.c_int, ptr]
    lib.masked_agg_acc_deq.restype = ctypes.c_int
    lib.masked_scatter_acc_launch.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ptr]
    lib.masked_scatter_acc_launch.restype = ctypes.c_int
    i64 = ctypes.c_int64
    lib.masked_agg_fold.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i64,
                                    i64, i64, i64, ctypes.c_int,
                                    ctypes.c_int, i64, ptr]
    lib.masked_agg_fold.restype = ctypes.c_int
    lib.masked_agg_error_string.argtypes = [ctypes.c_int]
    lib.masked_agg_error_string.restype = ctypes.c_char_p
    return lib


def _check_common(acc, mask, w_m, w_rest, z: int, *others) -> None:
    """The checks every fold shares: acc (N,) f32, mask (N,) bool, weights
    (Z,) f32, and every tensor contiguous on one cpu or cuda device."""
    if acc.dtype != torch.float32 or acc.dim() != 1:
        raise ValueError(f"accumulator must be f32 (N,), got {acc.dtype} "
                         f"{tuple(acc.shape)}")
    if mask.dtype != torch.bool or tuple(mask.shape) != tuple(acc.shape):
        raise ValueError(f"mask must be bool (N,), got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    for name, w in (("w_m", w_m), ("w_rest", w_rest)):
        if w.dtype != torch.float32 or tuple(w.shape) != (z,):
            raise ValueError(f"{name} must be f32 ({z},), got {w.dtype} "
                             f"{tuple(w.shape)}")
    tensors = (acc, mask, w_m, w_rest) + others
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all inputs must share a device, got "
                         f"{[str(t.device) for t in tensors]}")
    if acc.device.type not in _DEVICES:
        raise ValueError(f"unsupported device {acc.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")


def _check(acc, x, mask, w_m, w_rest) -> None:
    if x.dim() != 2 or acc.dim() != 1 or x.shape[1] != acc.shape[0]:
        raise ValueError(f"need acc (N,) and x (Z, N), got {tuple(acc.shape)}"
                         f" and {tuple(x.shape)}")
    if x.dtype not in _X_DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    _check_common(acc, mask, w_m, w_rest, x.shape[0], x)


def _log2_quant_block(quant_block: int) -> int:
    if quant_block <= 0 or quant_block > 128 or \
            quant_block & (quant_block - 1):
        raise ValueError(f"quant_block must be a power of two in 1..128, "
                         f"got {quant_block}")
    return quant_block.bit_length() - 1


def _raise_on(err: int, name: str) -> None:
    if err:
        msg = _lib().masked_agg_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")


def masked_agg_acc_(acc: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
                    w_m: torch.Tensor, w_rest: torch.Tensor) -> torch.Tensor:
    """``acc[n] += sum_z gate(x[z, n]) * (mask[n] ? w_m[z] : w_rest[z])``,
    in place; returns ``acc``.

    acc (N,) f32; x (Z, N) f32 or bf16; mask (N,) bool; w_m, w_rest (Z,)
    f32 — all contiguous, on one device.  The kernel launches on the
    current stream of ``acc``'s device and does not synchronise."""
    work.refuse_dtensor("masked_agg_acc_", acc, x, mask, w_m, w_rest)
    _check(acc, x, mask, w_m, w_rest)
    z, n = x.shape
    with work.kernel("masked_agg_acc", 2 * z * n,
                     2 * work.nbytes(acc) + work.nbytes(x, mask, w_m, w_rest)):
        return _masked_agg_acc(acc, x, mask, w_m, w_rest)


masked_agg_acc_.launches = 0


def _masked_agg_acc(acc, x, mask, w_m, w_rest):
    z, n = x.shape
    if acc.device.type == "meta":
        return acc
    if acc.device.type == "cpu":
        return acc.copy_(masked_agg_acc_ref(acc, x, mask, w_m, w_rest))
    if z == 0 or n == 0:
        return acc
    lib = _lib()
    vec4 = (n % 4 == 0 and acc.data_ptr() % 16 == 0
            and x.data_ptr() % (4 * x.element_size()) == 0
            and mask.data_ptr() % 4 == 0)
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream(acc.device).cuda_stream
        err = lib.masked_agg_acc(acc.data_ptr(), x.data_ptr(),
                                 mask.data_ptr(), w_m.data_ptr(),
                                 w_rest.data_ptr(), z, n,
                                 int(x.dtype == torch.bfloat16), int(vec4),
                                 stream)
    _raise_on(err, "masked_agg_acc")
    masked_agg_acc_.launches += 1
    return acc


def masked_agg_acc_deq_(acc: torch.Tensor, q: torch.Tensor,
                        scales: torch.Tensor, mask: torch.Tensor,
                        w_m: torch.Tensor, w_rest: torch.Tensor, *,
                        quant_block: int) -> torch.Tensor:
    """``acc[n] += sum_z gate(q[z, n] * scales[z, n // quant_block]) *
    (mask[n] ? w_m[z] : w_rest[z])``, in place; returns ``acc``.

    acc (N,) f32; q (Z, N) int8 with N a multiple of ``quant_block`` (a
    power of two up to 128); scales (Z, N / quant_block) f32; mask (N,)
    bool; w_m, w_rest (Z,) f32 — all contiguous, on one device.  A NaN
    scale row at weight 0 is gated out.  Launches on the current stream
    and does not synchronise."""
    work.refuse_dtensor("masked_agg_acc_deq_", acc, q, scales, mask, w_m,
                        w_rest)
    log2_qb = _log2_quant_block(quant_block)
    if q.dtype != torch.int8 or q.dim() != 2 or acc.dim() != 1 \
            or q.shape[1] != acc.shape[0]:
        raise ValueError(f"need acc (N,) and int8 q (Z, N), got "
                         f"{tuple(acc.shape)} and {q.dtype} "
                         f"{tuple(q.shape)}")
    z, n = q.shape
    if n % quant_block:
        raise ValueError(f"N={n} not a multiple of quant_block="
                         f"{quant_block}")
    if scales.dtype != torch.float32 or \
            tuple(scales.shape) != (z, n // quant_block):
        raise ValueError(f"scales must be f32 {(z, n // quant_block)}, got "
                         f"{scales.dtype} {tuple(scales.shape)}")
    _check_common(acc, mask, w_m, w_rest, z, q, scales)
    with work.kernel("masked_agg_acc_deq", 3 * z * n,
                     2 * work.nbytes(acc)
                     + work.nbytes(q, scales, mask, w_m, w_rest)):
        return _masked_agg_acc_deq(acc, q, scales, mask, w_m, w_rest,
                                   quant_block, log2_qb)


masked_agg_acc_deq_.launches = 0


def _masked_agg_acc_deq(acc, q, scales, mask, w_m, w_rest, quant_block,
                        log2_qb):
    z, n = q.shape
    if acc.device.type == "meta":
        return acc
    if acc.device.type == "cpu":
        return acc.copy_(masked_agg_acc_deq_ref(
            acc, q, scales, mask, w_m, w_rest, quant_block=quant_block))
    if z == 0 or n == 0:
        return acc
    lib = _lib()
    vec16 = (n % 16 == 0 and acc.data_ptr() % 16 == 0
             and q.data_ptr() % 16 == 0 and mask.data_ptr() % 16 == 0)
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream(acc.device).cuda_stream
        err = lib.masked_agg_acc_deq(acc.data_ptr(), q.data_ptr(),
                                     scales.data_ptr(), mask.data_ptr(),
                                     w_m.data_ptr(), w_rest.data_ptr(), z, n,
                                     log2_qb, int(vec16), stream)
    _raise_on(err, "masked_agg_acc_deq")
    masked_agg_acc_deq_.launches += 1
    return acc


def scatter_span(n: int, z: int, k: int) -> int:
    """The acc positions one K3 block owns: the most, halved while the
    entries a span expects (``z * k * span / n``) exceed what a block
    stages at once, down to the least.  A power of two."""
    span, least = SCATTER_SPAN[1], SCATTER_SPAN[0]
    while span > least and z * k * span > SCATTER_STAGE * n:
        span //= 2
    return span


def masked_scatter_acc_(acc: torch.Tensor, values: torch.Tensor,
                        scales: Optional[torch.Tensor],
                        indices: torch.Tensor, mask: torch.Tensor,
                        w_m: torch.Tensor, w_rest: torch.Tensor, *,
                        quant_block: int) -> torch.Tensor:
    """Scatter-fold top-k payloads into ``acc`` in place; returns ``acc``.

    Row by row in z order (rows whose two weights are both 0 are dropped):
    ``acc[p] += gate(v * s) * w`` for each entry ``j`` of row ``z``, with
    ``p = indices[z, j]``, ``v = values[z, j]``, ``s = scales[z, j //
    quant_block]`` (1 without scales) and ``w = mask[p] ? w_m[z] :
    w_rest[z]``.

    acc (N,) f32; values (Z, k) int8, bf16 or f32; scales (Z, k /
    quant_block) f32 or ``None``; indices (Z, k) int32; mask (N,) bool;
    w_m, w_rest (Z,) f32 — all contiguous, on one device.  **Index
    contract** (what ``comm.sparse_encode`` ships, and not checked here:
    that would cost a host sync per fold): each row's indices are
    distinct, sorted ascending and inside ``[0, N)``.  The kernels find a
    row's entries in each span of ``acc`` from the sorted order and drop
    any entry outside the span, so a broken contract gives a wrong sum,
    never an access out of bounds.  A memset and two launches (each row's
    run in each span, then the fold over the spans that have entries) on
    the current stream, with an int32 scratch of ``(2 Z + 2) N / span``;
    does not synchronise."""
    work.refuse_dtensor("masked_scatter_acc_", acc, values, scales, indices,
                        mask, w_m, w_rest)
    log2_qb = _log2_quant_block(quant_block)
    if values.dim() != 2 or values.dtype not in _VALUE_KINDS:
        raise ValueError(f"values must be (Z, k) int8, bf16 or f32, got "
                         f"{values.dtype} {tuple(values.shape)}")
    z, k = values.shape
    if k % quant_block:
        raise ValueError(f"k={k} not a multiple of quant_block="
                         f"{quant_block}")
    if indices.dtype != torch.int32 or tuple(indices.shape) != (z, k):
        raise ValueError(f"indices must be int32 {(z, k)}, got "
                         f"{indices.dtype} {tuple(indices.shape)}")
    extra = (values, indices)
    if scales is not None:
        if scales.dtype != torch.float32 or \
                tuple(scales.shape) != (z, k // quant_block):
            raise ValueError(f"scales must be f32 {(z, k // quant_block)}, "
                             f"got {scales.dtype} {tuple(scales.shape)}")
        extra += (scales,)
    _check_common(acc, mask, w_m, w_rest, z, *extra)
    n = acc.shape[0]
    if n >= 2**31 or z > _MAX_SCATTER_ROWS:
        raise ValueError(f"N={n} or Z={z} beyond the kernel's range "
                         f"(N < 2**31, Z <= {_MAX_SCATTER_ROWS})")
    # each entry reads and writes its acc element and reads its mask bit
    with work.kernel("masked_scatter_acc", (2 if scales is None else 3)
                     * z * k, z * k * (8 + mask.element_size())
                     + work.nbytes(values, indices, scales, w_m, w_rest)):
        return _masked_scatter_acc(acc, values, scales, indices, mask, w_m,
                                   w_rest, quant_block, log2_qb)


masked_scatter_acc_.launches = 0


def _masked_scatter_acc(acc, values, scales, indices, mask, w_m, w_rest,
                        quant_block, log2_qb):
    z, k = values.shape
    n = acc.shape[0]
    if acc.device.type == "meta":
        return acc
    if acc.device.type == "cpu":
        return acc.copy_(masked_scatter_acc_ref(
            acc, values, scales, indices, mask, w_m, w_rest,
            quant_block=quant_block))
    if z == 0 or k == 0 or n == 0:
        return acc
    span = scatter_span(n, z, k)
    scratch = torch.empty(((2 * z + 2) * -(-n // span) + 1,),
                          dtype=torch.int32, device=acc.device)
    lib = _lib()
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream(acc.device).cuda_stream
        err = lib.masked_scatter_acc_launch(
            acc.data_ptr(), values.data_ptr(),
            None if scales is None else scales.data_ptr(),
            indices.data_ptr(), mask.data_ptr(), w_m.data_ptr(),
            w_rest.data_ptr(), scratch.data_ptr(), z, k, n, span, log2_qb,
            _VALUE_KINDS[values.dtype], stream)
    _raise_on(err, "masked_scatter_acc")
    masked_scatter_acc_.launches += 2
    return acc


class FoldPlan(NamedTuple):
    """K4's work over one packed layout, on one device.

    ``leaves`` (L, 3) int64 rows ``(x_off, size, out_off)``: where a leaf
    starts in a row of the packed chunk buffer, its element count, and
    where it starts in the accumulator and the mask (the layout's offset
    both times: the accumulator is laid out like a packed row, and its
    padding is never written).  ``items`` (n_items, 2) int32 rows ``(leaf,
    tile)``: tile ``t`` covers the leaf's elements ``[t * TILE, (t + 1) *
    TILE)``, cut at its end.  ``length``: the least row, accumulator and
    mask length the tables address.  ``elements``: the leaves' sizes
    summed (the elements one row folds)."""
    leaves: torch.Tensor
    items: torch.Tensor
    length: int
    elements: int


def fold_tables(slots) -> Tuple[torch.Tensor, torch.Tensor]:
    """The leaf table and the work list of :class:`FoldPlan` (on the CPU)
    for layout slots (anything with ``offset`` and ``size``)."""
    leaves = torch.tensor([[s.offset, s.size, s.offset] for s in slots],
                          dtype=torch.int64).reshape(-1, 3)
    tiles = (leaves[:, 1] + TILE - 1) // TILE
    leaf = torch.repeat_interleave(torch.arange(len(slots)), tiles)
    first = torch.repeat_interleave(torch.cumsum(tiles, 0) - tiles, tiles)
    tile = torch.arange(int(tiles.sum())) - first
    return leaves, torch.stack([leaf, tile], dim=1).to(torch.int32)


_PLANS: Dict[Tuple[str, str], FoldPlan] = {}


def fold_plan(layout, device) -> FoldPlan:
    """The :class:`FoldPlan` of a ``FlatLayout`` on ``device``, built once
    per layout signature and device and kept there, so a fold copies
    nothing from the host and never synchronises."""
    key = (layout.signature, str(torch.device(device)))
    if key not in _PLANS:
        leaves, items = fold_tables(layout.slots)
        end = int((leaves[:, 0] + leaves[:, 1]).max()) if len(leaves) else 0
        _PLANS[key] = FoldPlan(leaves.to(device), items.to(device), end,
                               int(leaves[:, 1].sum()))
    return _PLANS[key]


def _launch_fold(out, x, mask, w_m, w_rest, plan: Optional[FoldPlan],
                 n: int, accumulate: bool) -> None:
    z = x.shape[0]
    ld = x.stride(0) if z > 1 else max(n, 1)
    leaves = items = None
    n_items = 0
    if plan is not None:
        leaves, items = plan.leaves.data_ptr(), plan.items.data_ptr()
        n_items = plan.items.shape[0]
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.masked_agg_fold(out.data_ptr(), x.data_ptr(),
                                  mask.data_ptr(), w_m.data_ptr(),
                                  w_rest.data_ptr(), leaves, items, n_items,
                                  n, z, ld, int(x.dtype == torch.bfloat16),
                                  int(accumulate), TILE, stream)
    _raise_on(err, "masked_agg_fold" if accumulate else "masked_agg")


def masked_agg_fold_(acc: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
                     w_m: torch.Tensor, w_rest: torch.Tensor,
                     plan: FoldPlan) -> torch.Tensor:
    """The tree engine's fold, in place; returns ``acc``.  For every leaf
    ``(x_off, size, out_off)`` of ``plan``:

        acc[o + n] += sum_z gate(x[z, x_off + n]) * w[z, o + n],
        o = out_off, n < size, w[z, m] = mask[m] ? w_m[z] : w_rest[z]

    the sum in f32 from 0, added once (bitwise ``acc[o:o + size].add_(
    masked_agg_(x[:, x_off:x_off + size], ...))``).  acc (M,) f32 and mask
    (M,) bool with M >= plan.length; x (Z, >= plan.length) f32 (the packed
    chunk buffer); w_m, w_rest (Z,) f32; plan on the same device; all
    contiguous.  One launch on the current stream, no synchronisation."""
    work.refuse_dtensor("masked_agg_fold_", acc, x, mask, w_m, w_rest)
    if x.dtype != torch.float32 or x.dim() != 2 or \
            x.shape[1] < plan.length:
        raise ValueError(f"x must be f32 (Z, >= {plan.length}), got "
                         f"{x.dtype} {tuple(x.shape)}")
    if acc.dim() != 1 or acc.shape[0] < plan.length:
        raise ValueError(f"accumulator must be (>= {plan.length},), got "
                         f"{tuple(acc.shape)}")
    _check_common(acc, mask, w_m, w_rest, x.shape[0], x, plan.leaves,
                  plan.items)
    z, e = x.shape[0], plan.elements
    with work.kernel("masked_agg_fold", 2 * z * e, e * (
            z * x.element_size() + 2 * acc.element_size()
            + mask.element_size()) + work.nbytes(w_m, w_rest)):
        return _masked_agg_fold(acc, x, mask, w_m, w_rest, plan)


masked_agg_fold_.launches = 0


def _masked_agg_fold(acc, x, mask, w_m, w_rest, plan):
    if acc.device.type == "meta":
        return acc
    if acc.device.type == "cpu":
        return acc.copy_(masked_agg_fold_ref(acc, x, mask, w_m, w_rest,
                                             plan.leaves))
    if x.shape[0] == 0 or plan.items.shape[0] == 0:
        return acc
    _launch_fold(acc, x, mask, w_m, w_rest, plan, 0, accumulate=True)
    masked_agg_fold_.launches += 1
    return acc


def masked_agg_(x: torch.Tensor, mask: torch.Tensor, w_m: torch.Tensor,
                w_rest: torch.Tensor) -> torch.Tensor:
    """``out[n] = sum_z gate(x[z, n]) * (mask[n] ? w_m[z] : w_rest[z])``
    summed in f32 and returned as a new (N,) tensor in ``x``'s dtype.

    x (Z, N) f32 or bf16 with unit element stride; its rows may lie any
    ``x.stride(0) >= N`` elements apart (a leaf's columns of the packed
    chunk buffer).  mask (N,) bool; w_m, w_rest (Z,) f32 — contiguous, on
    x's device.  K4's kernel with a table of this one leaf; launches on
    the current stream and does not synchronise."""
    work.refuse_dtensor("masked_agg_", x, mask, w_m, w_rest)
    if x.dim() != 2 or x.dtype not in _X_DTYPES:
        raise ValueError(f"x must be float32 or bfloat16 (Z, N), got "
                         f"{x.dtype} {tuple(x.shape)}")
    z, n = x.shape
    if (n > 1 and x.stride(1) != 1) or (z > 1 and x.stride(0) < n):
        raise ValueError(f"x's rows must be dense and apart by >= N, got "
                         f"strides {x.stride()} for {tuple(x.shape)}")
    if mask.dtype != torch.bool or tuple(mask.shape) != (n,):
        raise ValueError(f"mask must be bool ({n},), got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    for name, w in (("w_m", w_m), ("w_rest", w_rest)):
        if w.dtype != torch.float32 or tuple(w.shape) != (z,):
            raise ValueError(f"{name} must be f32 ({z},), got {w.dtype} "
                             f"{tuple(w.shape)}")
    tensors = (x, mask, w_m, w_rest)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all inputs must share a device, got "
                         f"{[str(t.device) for t in tensors]}")
    if x.device.type not in _DEVICES:
        raise ValueError(f"unsupported device {x.device}")
    if not all(t.is_contiguous() for t in tensors[1:]):
        raise ValueError("mask and weights must be contiguous")
    with work.kernel("masked_agg", 2 * z * n, z * n * x.element_size()
                     + n * x.element_size() + work.nbytes(mask, w_m, w_rest)):
        return _masked_agg(x, mask, w_m, w_rest)


masked_agg_.launches = 0


def _masked_agg(x, mask, w_m, w_rest):
    z, n = x.shape
    if x.device.type == "cpu":
        return masked_agg_ref(x, mask, w_m, w_rest)
    out = torch.empty((n,), dtype=x.dtype, device=x.device)
    if x.device.type == "meta":
        return out
    if z == 0 or n == 0:
        return out.zero_()
    _launch_fold(out, x, mask, w_m, w_rest, None, n, accumulate=False)
    masked_agg_.launches += 1
    return out


def masked_agg_leaf(x: torch.Tensor, mask, w_m: torch.Tensor,
                    w_rest: torch.Tensor) -> torch.Tensor:
    """One stacked leaf: x (Z, *shape) and a mask broadcastable to
    ``shape`` (a Python bool, or a bool tensor on x's device) -> the
    leaf's masked sum, shaped ``shape``, in x's dtype (one K4 launch on
    the card)."""
    z, shape = x.shape[0], x.shape[1:]
    mask_flat = torch.as_tensor(mask, dtype=torch.bool,
                                device=x.device).expand(shape).reshape(-1)
    return masked_agg_(x.reshape(z, -1), mask_flat.contiguous(), w_m,
                       w_rest).reshape(shape)


def masked_agg_tree(cohort: Tree, mask_tree: Tree, w_m: torch.Tensor,
                    w_rest: torch.Tensor) -> Tree:
    """:func:`masked_agg_leaf` over every leaf of a stacked cohort tree.
    Weights are raw per-client coefficients: a weighted sum, not a
    mean."""
    return tree_map(lambda x, m: masked_agg_leaf(x, m, w_m, w_rest),
                    cohort, mask_tree)
