"""Wrapper of the RG-LRU scan kernel (``csrc/lru_scan.cu``, K6).

``lru_scan`` replaces the reference's
``repro.kernels.rglru_scan.kernel.lru_scan_pallas``, which its
``ops.lru_scan`` runs on a TPU in place of the model's associative scan:
``y_t = a_t * y_{t-1} + b_t`` per channel, an f32 carry from 0, forward
only.  On CPU tensors it runs the plain version (``ref.py``); on CUDA
tensors it launches the kernel or raises — there is no fallback.
``lru_scan.launches`` counts kernel launches (never plain-version
calls).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rglru_scan.ref import lru_scan_ref

_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load()
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.lru_scan.argtypes = [ptr, ptr, ptr, i64, i64, i64, ctypes.c_int, ptr]
    lib.lru_scan.restype = ctypes.c_int
    lib.lru_scan_error_string.argtypes = [ctypes.c_int]
    lib.lru_scan_error_string.restype = ctypes.c_char_p
    return lib


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
    lib = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.lru_scan(y.data_ptr(), a.data_ptr(), b.data_ptr(), bsz, s,
                           d, int(a.dtype == torch.bfloat16), stream)
    if err:
        msg = lib.lru_scan_error_string(err).decode()
        raise RuntimeError(f"lru_scan launch failed: {msg} ({err})")
    lru_scan.launches += 1
    return y


lru_scan.launches = 0
