"""Wrappers of the flash attention kernels (K5): ``csrc/flash_attention_wgmma.cu``
for bf16, ``csrc/flash_attention.cu`` for f32.

``flash_attention`` replaces the reference's
``repro.kernels.flash_attention.kernel.flash_attention_pallas``, which its
``ops.flash_attention`` runs on a TPU in place of the model's chunked
path (the same contract): causal, optionally sliding-window GQA attention
with an optional tanh softcap, forward only.  On CPU tensors it runs the
plain version (``ref.py``).  On CUDA tensors it picks a kernel by dtype,
explicitly: bf16 launches the tensor-core kernel (wgmma, planned by
:func:`plan_wgmma`), f32 the CUDA-core kernel (planned by
:func:`plan_f32`), which keeps f32 products; anything the kernels do not
take raises — there is no fallback.  On ``meta`` tensors (the dry-runs) it
returns the output's shape and dtype and computes nothing, and on every
device it reports its work to an active roofline walk
(``kernels/work.py``): 4 Dh flops a kept (query, key) pair and head, the
bytes of q, k, v and the output.  ``flash_attention.launches_tc`` and
``flash_attention.launches`` count the tensor-core and the CUDA-core
kernel's launches on whole sequences (never plain-version calls), so a run
can show which kernel its prefill went through; ``launches_tc_rows`` and
``launches_rows`` count their launches on a rank's query rows (a
``q_offset`` past 0, or more keys than queries).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build, work
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

_DTYPES = (torch.float32, torch.bfloat16)
# the kernels' instantiations: the TPU kernel takes any Dh; these are the
# zoo's (kimi-k2's 112 runs padded to 128 columns in shared memory)
HEAD_DIMS = (32, 64, 112, 128, 256)

# the tensor-core kernel's tile (csrc/flash_attention_wgmma.cu): two
# warpgroups of 64 (query, head) rows, keys in tiles of 64 through a ring
# of 2 K/V stages
TC_ROWS, TC_KEYS, TC_STAGES = 128, 64, 2


def wgmma_width(dh: int) -> int:
    """Columns a row of Q, K or V takes in the tensor-core kernel's shared
    memory: Dh rounded up to whole 64-column blocks (32 -> 64, 112 ->
    128), the padding loaded as 0."""
    return 64 if dh <= 64 else -(-dh // 64) * 64


def f32_width(dh: int) -> int:
    """Columns a row of Q, K or V takes in the CUDA-core kernel's shared
    memory: Dh rounded up to 32, 64, 128 or 256 (112 -> 128), the padding
    loaded as 0."""
    return next(w for w in (32, 64, 128, 256) if w >= dh)


class WgmmaPlan(NamedTuple):
    """Launch of the tensor-core kernel for one call (see
    ``csrc/flash_attention_wgmma.cu``)."""
    g_blk: int          # query heads of one kv head a block takes
    bq: int             # queries a block takes (g_blk * bq <= TC_ROWS rows)
    n_qblocks: int
    n_groups: int       # head groups per kv head (G > TC_ROWS only)
    grid: int           # blocks: q-blocks x head groups x B x Kh
    smem_bytes: int     # Q + the K/V ring, 128-byte swizzled, + 1 KiB align


def plan_wgmma(b: int, s: int, h: int, kh: int, dh: int,
               dtype: torch.dtype) -> WgmmaPlan:
    """The tensor-core kernel's launch for q (b, s, h, dh) and k, v (b, s,
    kh, dh): rows are (query, head) pairs of one kv head in query-major
    order, all G = h / kh heads (at most TC_ROWS) times TC_ROWS // G
    queries.  Raises on what the kernel does not take."""
    if dtype != torch.bfloat16:
        raise ValueError(f"the tensor-core kernel takes bfloat16, got "
                         f"{dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {dh} not supported by the kernel "
                         f"(expected one of {HEAD_DIMS})")
    if kh < 1 or h % kh or b < 1 or s < 1:
        raise ValueError(f"no launch for B={b}, S={s}, H={h}, Kh={kh}")
    g = h // kh
    g_blk = min(g, TC_ROWS)
    bq = TC_ROWS // g_blk
    n_q, n_g = -(-s // bq), -(-g // g_blk)
    grid = n_q * n_g * b * kh
    if grid >= 2**31:
        raise ValueError(f"{grid} blocks are beyond the kernel's grid")
    smem = 2 * wgmma_width(dh) * (TC_ROWS + 2 * TC_STAGES * TC_KEYS) + 1024
    return WgmmaPlan(g_blk, bq, n_q, n_g, grid, smem)


# the CUDA-core kernel's tile (csrc/flash_attention.cu): 8 rows x 8 keys of
# scores a thread, 64 (query, head) rows a block, a row group's 8 rows
# shared by 16 threads (32 at Dh 256), so keys in tiles of 128 (256); Q in
# shared memory, K and V through a ring of two chunks of a tile's keys x 32
# floats (+ 4 of padding), the tile's probabilities
F32_ROWS = 64


class F32Plan(NamedTuple):
    """Launch of the CUDA-core kernel for one call (see
    ``csrc/flash_attention.cu``, which computes the same plan)."""
    g_blk: int          # query heads of one kv head a block takes
    bq: int             # queries a block takes (g_blk * bq <= F32_ROWS)
    n_qblocks: int
    n_groups: int       # head groups per kv head (G > F32_ROWS only)
    grid: int           # blocks: q-blocks x head groups x B x Kh
    threads: int        # = keys a tile: 128, at Dh 256 256
    smem_bytes: int     # Q, the K/V ring, P
    blocks_per_sm: int  # 2 where Dh <= 128


def plan_f32(b: int, s: int, h: int, kh: int, dh: int,
             dtype: torch.dtype) -> F32Plan:
    """The CUDA-core kernel's launch for q (b, s, h, dh) and k, v (b, s,
    kh, dh): rows are (query, head) pairs of one kv head in query-major
    order, all G = h / kh heads (at most F32_ROWS) times F32_ROWS // G
    queries.  Raises on what the kernel does not take."""
    if dtype != torch.float32:
        raise ValueError(f"the CUDA-core kernel takes float32, got {dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {dh} not supported by the kernel "
                         f"(expected one of {HEAD_DIMS})")
    if kh < 1 or h % kh or b < 1 or s < 1:
        raise ValueError(f"no launch for B={b}, S={s}, H={h}, Kh={kh}")
    g = h // kh
    g_blk = min(g, F32_ROWS)
    bq = F32_ROWS // g_blk
    n_q, n_g = -(-s // bq), -(-g // g_blk)
    grid = n_q * n_g * b * kh
    if grid >= 2**31:
        raise ValueError(f"{grid} blocks are beyond the kernel's grid")
    dp = f32_width(dh)
    big = dp == 256
    keys = 256 if big else 128                  # = threads
    q_tile = F32_ROWS * (dp + 4)
    ring = 2 * keys * (32 + 4)
    p_tile = F32_ROWS * (keys + 16)
    return F32Plan(g_blk, bq, n_q, n_g, grid, keys,
                   4 * (q_tile + ring + p_tile), 1 if big else 2)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    f32 = ctypes.c_float
    # the kernels on query rows q_offset .. q_offset + Sq - 1 of Sk keys:
    # (..., b, s_q, s_k, q_offset, h, ...)
    lib.flash_attention_fwd_rows.argtypes = [ptr, ptr, ptr, ptr, i32, i32,
                                             i32, i32, i32, i32, i32, i32,
                                             f32, f32, ptr]
    lib.flash_attention_fwd_rows.restype = ctypes.c_int
    lib.flash_attention_wgmma_fwd_rows.argtypes = [
        ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i32, i32,
        i32, f32, f32, i32, ptr]
    lib.flash_attention_wgmma_fwd_rows.restype = ctypes.c_int
    lib.flash_attention_f32_smem.argtypes = [i32]
    lib.flash_attention_f32_smem.restype = i32
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, window: int, softcap: float, q_offset: int = 0) -> None:
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"need q (B, Sq, H, Dh) and k, v (B, Sk, Kh, Dh), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or k.shape[2] == 0 \
            or h % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}"
                         f" (same B, Dh; H a multiple of Kh)")
    if q_offset < 0 or q_offset + s > k.shape[1]:
        raise ValueError(f"queries at positions {q_offset}..{q_offset + s - 1}"
                         f" need q_offset >= 0 and q_offset + Sq <= Sk = "
                         f"{k.shape[1]} keys")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or all bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k and v must share a device")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {q.device}")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise ValueError("flash_attention is forward only, as the TPU "
                         "kernel is: inputs must not require grad")
    if window < 0 or softcap < 0:
        raise ValueError(f"window and softcap must be >= 0, got {window}, "
                         f"{softcap}")


def causal_pairs(s: int, window: int, q_offset: int = 0) -> int:
    """(query, key) pairs a causal window keeps for the ``s`` queries at
    positions ``q_offset .. q_offset + s - 1``: key j <= query i and, when
    windowed, i - j < window."""
    if q_offset:
        return (causal_pairs(q_offset + s, window)
                - causal_pairs(q_offset, window))
    if not window or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0, softcap: float = 0.0,
                    q_offset: int = 0) -> torch.Tensor:
    """q (B, Sq, H, Dh), k and v (B, Sk, Kh, Dh) -> (B, Sq, H, Dh) in
    ``q.dtype``.  Query row ``i`` sits at position ``q_offset + i``
    (``q_offset + Sq <= Sk``; 0 with ``Sq = Sk`` is a whole sequence, and
    a rank of a sequence split passes its first row and the key prefix it
    can see).  Causal; ``window > 0`` also drops keys ``window`` or more
    positions behind the query; ``softcap > 0`` caps the scaled scores
    with ``tanh(x / softcap) * softcap``.  Query head ``h`` reads kv head
    ``h // (H // Kh)``.

    On CUDA: contiguous 16-byte aligned inputs, Dh in ``HEAD_DIMS``; bf16
    runs on the tensor cores (probabilities rounded to bf16 for the PV
    product, as the model's ``_attend`` rounds them), f32 on the CUDA
    cores; the kernel launches on the current stream and does not
    synchronise."""
    work.refuse_dtensor("flash_attention", q, k, v)
    _check(q, k, v, window, softcap, q_offset)
    b, s, h, dh = q.shape
    with work.kernel("flash_attention", 4 * dh * causal_pairs(
            s, window, q_offset) * b * h,
            2 * work.nbytes(q) + work.nbytes(k, v)):
        return _flash_attention(q, k, v, window, softcap, q_offset)


def _flash_attention(q, k, v, window: int, softcap: float,
                     q_offset: int) -> torch.Tensor:
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, window=window, softcap=softcap,
                                   q_offset=q_offset)
    b, s, h, dh = q.shape
    kh, sk = k.shape[2], k.shape[1]
    if dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {dh} not supported by the kernel "
                         f"(expected one of {HEAD_DIMS})")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")
    if sk >= 2**31:
        raise ValueError(f"S = {sk} is beyond the kernels' indexing")
    if q.numel() == 0:
        return torch.empty_like(q)
    tc = q.dtype == torch.bfloat16
    plan = (plan_wgmma if tc else plan_f32)(b, s, h, kh, dh, q.dtype)
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = (out.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr())
        if tc:
            err = lib.flash_attention_wgmma_fwd_rows(
                *ptrs, b, s, sk, q_offset, h, kh, dh, plan.g_blk, plan.bq,
                window, softcap, dh ** -0.5, plan.smem_bytes, stream)
        else:
            err = lib.flash_attention_fwd_rows(
                *ptrs, b, s, sk, q_offset, h, kh, dh, window, softcap,
                dh ** -0.5, stream)
    if err:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg} ({err})")
    rows = "_rows" if q_offset or sk != s else ""
    name = ("launches_tc" if tc else "launches") + rows
    setattr(flash_attention, name, getattr(flash_attention, name) + 1)
    return out


flash_attention.launches = 0        # the CUDA-core kernel (f32)
flash_attention.launches_tc = 0     # the tensor-core kernel (bf16)
# the same kernels on query rows past the first or against more keys than
# queries (a rank's rows of a sequence split): counted apart
flash_attention.launches_rows = 0
flash_attention.launches_tc_rows = 0
