"""Wrapper of the flash attention kernel (``csrc/flash_attention.cu``, K5).

``flash_attention`` replaces the reference's
``repro.kernels.flash_attention.kernel.flash_attention_pallas``, which its
``ops.flash_attention`` runs on a TPU in place of the model's chunked
path (the same contract): causal, optionally sliding-window GQA attention
with an optional tanh softcap, forward only.  On CPU tensors it runs the
plain version (``ref.py``); on CUDA tensors it launches the kernel or
raises — there is no fallback.  ``flash_attention.launches`` counts
kernel launches (never plain-version calls), so a run can show that its
prefill went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (32, 64, 128, 256)     # the kernel's instantiations


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32,
                                        i32, i32, i32, ctypes.c_float,
                                        ctypes.c_float, i32, ptr]
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, window: int, softcap: float) -> None:
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"need q (B, S, H, Dh) and k, v (B, S, Kh, Dh), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, dh = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != dh \
            or k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}"
                         f" (same B, S, Dh; H a multiple of Kh)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or all bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k and v must share a device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise ValueError("flash_attention is forward only, as the TPU "
                         "kernel is: inputs must not require grad")
    if window < 0 or softcap < 0:
        raise ValueError(f"window and softcap must be >= 0, got {window}, "
                         f"{softcap}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """q (B, S, H, Dh), k and v (B, S, Kh, Dh) -> (B, S, H, Dh) in
    ``q.dtype``.  Causal; ``window > 0`` also drops keys ``window`` or more
    positions behind the query; ``softcap > 0`` caps the scaled scores
    with ``tanh(x / softcap) * softcap``.  Query head ``h`` reads kv head
    ``h // (H // Kh)``.

    On CUDA: contiguous 16-byte aligned inputs, Dh in ``HEAD_DIMS``; the
    kernel launches on the current stream and does not synchronise."""
    _check(q, k, v, window, softcap)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, window=window, softcap=softcap)
    b, s, h, dh = q.shape
    kh = k.shape[2]
    if dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {dh} not supported by the kernel "
                         f"(expected one of {HEAD_DIMS})")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")
    if b * kh > 65535 or s >= 2**31:
        raise ValueError(f"B * Kh = {b * kh} or S = {s} is beyond the "
                         f"kernel's grid")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            out.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), b, s,
            h, kh, dh, window, softcap, dh ** -0.5,
            int(q.dtype == torch.bfloat16), stream)
    if err:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg} ({err})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
