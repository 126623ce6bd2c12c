"""Shared building blocks of the port's models: norm, loss, init helpers.

Parameters are plain nested dicts of tensors, as in the reference;
activations are NCHW (PyTorch's convention) inside the models.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def dense_init(generator: torch.Generator, shape, fan_in: Optional[int] = None
               ) -> torch.Tensor:
    """Truncated-normal (+-2 std) fan-in init, the reference's scheme (its
    draws come from JAX keys, so the values differ)."""
    if fan_in is None:
        fan_in = shape[0] if len(shape) > 1 else shape[-1]
    out = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return out / math.sqrt(max(fan_in, 1))


def init_groupnorm(channels: int) -> dict:
    return {"scale": torch.ones((channels,), dtype=torch.float32),
            "bias": torch.zeros((channels,), dtype=torch.float32)}


def group_count(channels: int, groups: int = 8) -> int:
    """The reference's divisor walk: ``min(groups, c)``, decremented until
    it divides ``c``."""
    g = min(groups, channels)
    while channels % g:
        g -= 1
    return g


def apply_groupnorm(p: dict, x: torch.Tensor, groups: int = 8,
                    eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over ``x`` (B, C, H, W): population variance, eps 1e-5,
    per-channel affine — the reference's ``apply_groupnorm`` on NCHW.

    ``F.group_norm`` is PyTorch's fused GroupNorm.  Its f32 backward is
    less exact than JAX's on tiny groups (about 1e-5 absolute error on
    groups of 2 values, where JAX's is 5e-7); the model's smallest groups
    at 32x32 inputs hold 1,024 values, and the parity tests use 16x16
    inputs (groups of 8 or more) for that reason."""
    g = group_count(x.shape[1], groups)
    return F.group_norm(x.float(), g, p["scale"].float(), p["bias"].float(),
                        eps).to(x.dtype)


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Mean NLL of integer ``labels`` under ``logits`` (..., V), in f32."""
    return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long())
