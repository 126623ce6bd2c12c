"""Wrappers of the RG-LRU scan kernel (``csrc/lru_scan.cu``, K6).

``lru_scan`` replaces the reference's
``repro.kernels.rglru_scan.kernel.lru_scan_pallas``, which its
``ops.lru_scan`` runs on a TPU in place of the model's associative scan:
``y_t = a_t * y_{t-1} + b_t`` per channel, an f32 carry from 0, forward
only.  ``lru_scan_gated`` is the same kernel fed from the recurrent
layer's input: it computes the gates (``models/rglru._gates``) in front of
the scan, in one launch, which is what the reference's prefill gives the
TPU kernel (``repro.models.rglru.lru_scan``, whose gates XLA fuses into
one pass).  On CPU tensors both run their plain versions (``ref.py``); on
CUDA tensors they launch the kernel, planned by :func:`scan_plan`, or
raise — there is no fallback.  ``lru_scan.launches`` and
``lru_scan_gated.launches`` count each entry's launches of K6 (never
plain-version calls).  The model's prefill runs K6 through the gated entry
only; the plain one is the TPU kernel's own contract, which the tests and
``chip_smoke.py``'s yardstick of the unfused gates call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rglru_scan.ref import (lru_scan_gated_ref,
                                                lru_scan_ref)

_DTYPES = (torch.float32, torch.bfloat16)


class Tiling(NamedTuple):
    """One entry's tiling (``csrc/lru_scan.cu``): a block owns a stripe of
    ``stripe`` channels of one batch row (a scan thread each) and walks
    time in tiles of ``tile`` steps through a ring of ``stages`` tiles that
    a producer warp fills; the gated entry adds ``gate_warps`` warps that
    compute a and b into a ring of ``ab_stages`` (a, b) tiles."""
    stripe: int
    tile: int
    stages: int
    ab_stages: int = 0
    gate_warps: int = 0


# the plain entry is memory-bound: wide rows, few blocks; the gated entry
# is bound by its gate math: narrow stripes, many blocks an SM (the
# kernel's Tiling<false> and Tiling<true>; ``kernel_layout`` reads them)
PLAIN = Tiling(stripe=128, tile=16, stages=4)
GATED = Tiling(stripe=32, tile=64, stages=4, ab_stages=2, gate_warps=8)


class ScanPlan(NamedTuple):
    """Launch of K6 for one call (see ``csrc/lru_scan.cu``, whose layout
    gives the same shared bytes)."""
    stripes: int        # channel stripes of a batch row
    grid: int           # blocks: B x stripes
    tiles: int          # time tiles a block walks
    threads: int        # scan warps + producer warp (+ the gate warps)
    smem_bytes: int     # the input ring, the (a, b) ring, mbarriers, align
    tma: bool           # the ring filled by TMA (else by the producer's
                        # loads)


def scan_plan(b: int, s: int, d: int, dtype: torch.dtype,
              gated: bool = False, aligned: bool = True) -> ScanPlan:
    """K6's launch for (B, S, D) inputs of ``dtype`` (x for ``gated``),
    tiled by the entry's tiling (``GATED`` or ``PLAIN``).  TMA takes rows
    of a multiple of 16 bytes from 16-byte aligned bases (``aligned``),
    and here only tensors at least one box (stripe x tile) wide and long.
    Raises on what the kernel does not take."""
    if dtype not in _DTYPES:
        raise ValueError(f"K6 takes float32 or bfloat16, got {dtype}")
    if b < 1 or s < 1 or d < 1:
        raise ValueError(f"no launch for B={b}, S={s}, D={d}")
    tl = GATED if gated else PLAIN
    elt = 4 if dtype == torch.float32 else 2
    stripes, tiles = -(-d // tl.stripe), -(-s // tl.tile)
    grid = b * stripes
    if grid >= 2**31 or tiles >= 2**31:
        raise ValueError(f"({b}, {s}, {d}) is beyond the kernel's grid")
    box = tl.tile * tl.stripe
    ring = tl.stages * (1 if gated else 2) * box * elt
    ab = tl.ab_stages * 2 * box * 4
    bars = 8 * (2 * tl.stages + 2 * tl.ab_stages)
    tma = (aligned and (d * elt) % 16 == 0 and d >= tl.stripe
           and s >= tl.tile)
    return ScanPlan(stripes, grid, tiles,
                    tl.stripe + 32 + 32 * tl.gate_warps,
                    ring + ab + bars + 128, tma)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``'s K6 entries typed for ctypes (the port's library, or a
    build of an edited copy of ``csrc/lru_scan.cu``)."""
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.lru_scan.argtypes = [ptr, ptr, ptr, i64, i64, i64, i32, i32, i32,
                             i32, i32, ptr]
    lib.lru_scan.restype = i32
    lib.lru_scan_gated.argtypes = [ptr] * 8 + [i64, i64, i64, i32, i32,
                                               i32, i32, i32, ptr]
    lib.lru_scan_gated.restype = i32
    lib.lru_scan_layout.argtypes = [i32, i32, ctypes.POINTER(i32)]
    lib.lru_scan_layout.restype = None
    lib.lru_scan_error_string.argtypes = [i32]
    lib.lru_scan_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return _bind(build.load())


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _raise_on(lib, err: int, name: str) -> None:
    if err:
        msg = lib.lru_scan_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")


def lru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b (B, S, D), both float32 or both bfloat16, contiguous, on one
    device -> y (B, S, D) in ``a.dtype``.  The kernel launches on the
    current stream and does not synchronise."""
    if a.dim() != 3 or tuple(a.shape) != tuple(b.shape):
        raise ValueError(f"need a, b of one shape (B, S, D), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise ValueError(f"a and b must both be float32 or both bfloat16, "
                         f"got {a.dtype} and {b.dtype}")
    if a.device != b.device or a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"a and b must share a cpu or cuda device, got "
                         f"{a.device} and {b.device}")
    if a.requires_grad or b.requires_grad:
        raise ValueError("lru_scan is forward only, as the TPU kernel is: "
                         "inputs must not require grad")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    if a.device.type == "cpu":
        return lru_scan_ref(a, b)
    bsz, s, d = a.shape
    y = torch.empty_like(a)
    if y.numel() == 0:
        return y
    plan = scan_plan(bsz, s, d, a.dtype, aligned=_aligned(a, b))
    lib = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.lru_scan(y.data_ptr(), a.data_ptr(), b.data_ptr(), bsz, s,
                           d, int(a.dtype == torch.bfloat16), plan.stripes,
                           plan.tiles, plan.smem_bytes, int(plan.tma),
                           stream)
    _raise_on(lib, err, "lru_scan")
    lru_scan.launches += 1
    return y


lru_scan.launches = 0


def lru_scan_gated(x: torch.Tensor, w_r: torch.Tensor, b_r: torch.Tensor,
                   w_i: torch.Tensor, b_i: torch.Tensor, c: torch.Tensor,
                   y0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The RG-LRU layer's recurrence from its input: x (B, S, D) float32
    or bfloat16; w_r, b_r, w_i, b_i and ``c = -8 softplus(lam)`` (D,)
    float32; y0 (B, D) float32 or None; all contiguous, on one device ->
    y (B, S, D) in ``x.dtype`` (``ref.lru_scan_gated_ref``).  The kernel
    launches on the current stream and does not synchronise."""
    vecs = (w_r, b_r, w_i, b_i, c)
    if x.dim() != 3 or x.dtype not in _DTYPES:
        raise ValueError(f"need x (B, S, D) float32 or bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    bsz, s, d = x.shape
    if any(v.shape != (d,) or v.dtype != torch.float32 for v in vecs):
        raise ValueError(f"w_r, b_r, w_i, b_i and c must be ({d},) float32, "
                         f"got {[(tuple(v.shape), v.dtype) for v in vecs]}")
    if y0 is not None and (y0.shape != (bsz, d)
                           or y0.dtype != torch.float32):
        raise ValueError(f"y0 must be ({bsz}, {d}) float32, got "
                         f"{tuple(y0.shape)} {y0.dtype}")
    ts = (x, *vecs) + (() if y0 is None else (y0,))
    if any(t.device != x.device for t in ts) or x.device.type not in (
            "cpu", "cuda"):
        raise ValueError(f"x, the gate vectors and y0 must share a cpu or "
                         f"cuda device, got {[str(t.device) for t in ts]}")
    if any(t.requires_grad for t in ts):
        raise ValueError("lru_scan_gated is forward only, as the TPU kernel "
                         "is: inputs must not require grad")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("x, the gate vectors and y0 must be contiguous")
    if x.device.type == "cpu":
        return lru_scan_gated_ref(x, w_r, b_r, w_i, b_i, c, y0)
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    plan = scan_plan(bsz, s, d, x.dtype, gated=True, aligned=_aligned(x))
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.lru_scan_gated(
            y.data_ptr(), x.data_ptr(), *(v.data_ptr() for v in vecs),
            None if y0 is None else y0.data_ptr(), bsz, s, d,
            int(x.dtype == torch.bfloat16), plan.stripes, plan.tiles,
            plan.smem_bytes, int(plan.tma), stream)
    _raise_on(lib, err, "lru_scan_gated")
    lru_scan_gated.launches += 1
    return y


lru_scan_gated.launches = 0


def kernel_layout(gated: bool, dtype: torch.dtype, lib=None) -> tuple:
    """(tiling, shared bytes) of the entry in a built library (the card
    only; ``lib`` by default the port's): the tiling that must stand in
    ``PLAIN`` or ``GATED`` for :func:`scan_plan` to plan its launches, and
    the shared bytes the plan must then give."""
    lib = lib or _lib()
    out = (ctypes.c_int * 6)()
    lib.lru_scan_layout(int(gated), int(dtype == torch.bfloat16), out)
    return Tiling(*out[:5]), out[5]
