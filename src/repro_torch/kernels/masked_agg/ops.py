"""Wrapper of the masked cohort fold kernel (``csrc/masked_agg_acc.cu``).

``masked_agg_acc_`` replaces the reference's
``repro.kernels.masked_agg.kernel.masked_agg_acc_pallas``: it folds a
``(Z, N)`` chunk into the f32 accumulator in place.  On CPU tensors it runs
the plain version (``ref.masked_agg_acc_ref``); on CUDA tensors it launches
the kernel or raises — there is no fallback.  ``masked_agg_acc_.launches``
counts kernel launches (never plain-version calls), so a run can show that
its folds went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.masked_agg.ref import masked_agg_acc_ref

_X_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load()
    ptr = ctypes.c_void_p
    lib.masked_agg_acc.argtypes = [ptr, ptr, ptr, ptr, ptr, ctypes.c_int64,
                                   ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                   ptr]
    lib.masked_agg_acc.restype = ctypes.c_int
    lib.masked_agg_error_string.argtypes = [ctypes.c_int]
    lib.masked_agg_error_string.restype = ctypes.c_char_p
    return lib


def _check(acc, x, mask, w_m, w_rest) -> None:
    if acc.dtype != torch.float32:
        raise ValueError(f"accumulator must be f32, got {acc.dtype}")
    if acc.dim() != 1 or x.dim() != 2 or x.shape[1] != acc.shape[0]:
        raise ValueError(f"need acc (N,) and x (Z, N), got {tuple(acc.shape)}"
                         f" and {tuple(x.shape)}")
    if x.dtype not in _X_DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if mask.dtype != torch.bool or tuple(mask.shape) != tuple(acc.shape):
        raise ValueError(f"mask must be bool (N,), got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    z = x.shape[0]
    for name, w in (("w_m", w_m), ("w_rest", w_rest)):
        if w.dtype != torch.float32 or tuple(w.shape) != (z,):
            raise ValueError(f"{name} must be f32 ({z},), got {w.dtype} "
                             f"{tuple(w.shape)}")
    tensors = (acc, x, mask, w_m, w_rest)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("acc, x, mask, w_m and w_rest must share a device, "
                         f"got {[str(t.device) for t in tensors]}")
    if acc.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {acc.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("acc, x, mask, w_m and w_rest must be contiguous")


def masked_agg_acc_(acc: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
                    w_m: torch.Tensor, w_rest: torch.Tensor) -> torch.Tensor:
    """``acc[n] += sum_z gate(x[z, n]) * (mask[n] ? w_m[z] : w_rest[z])``,
    in place; returns ``acc``.

    acc (N,) f32; x (Z, N) f32 or bf16; mask (N,) bool; w_m, w_rest (Z,)
    f32 — all contiguous, on one device.  The kernel launches on the
    current stream of ``acc``'s device and does not synchronise."""
    _check(acc, x, mask, w_m, w_rest)
    z, n = x.shape
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
    if err:
        msg = lib.masked_agg_error_string(err).decode()
        raise RuntimeError(f"masked_agg_acc launch failed: {msg} ({err})")
    masked_agg_acc_.launches += 1
    return acc


masked_agg_acc_.launches = 0
