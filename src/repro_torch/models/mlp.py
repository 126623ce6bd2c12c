"""Dense GLU MLP (gate, up, down): the port of ``repro.models.mlp``'s
dense layer.  Mixture-of-Experts is not ported yet (ROADMAP.md §1) and
raises ``NotImplementedError``."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (``F.gelu``'s
    default is the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def init_mlp(generator: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None) -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    dt = cfg.torch_param_dtype()
    p = {"up": common.dense_init(generator, (d, f), dtype=dt),
         "down": common.dense_init(generator, (f, d), fan_in=f, dtype=dt)}
    if cfg.mlp_glu:
        p["gate"] = common.dense_init(generator, (d, f), dtype=dt)
    return p


def apply_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x (..., D) -> (..., D) in ``x.dtype``."""
    u = torch.matmul(x, p["up"].to(x.dtype))
    if "gate" in p:
        h = gelu(torch.matmul(x, p["gate"].to(x.dtype))) * u
    else:
        h = gelu(u)
    return torch.matmul(h, p["down"].to(x.dtype))


def init_moe(generator: torch.Generator, cfg: ModelConfig) -> dict:
    raise NotImplementedError("MoE layers are not ported to repro_torch yet "
                              "(ROADMAP.md §1)")


def apply_moe(p: dict, x: torch.Tensor, cfg: ModelConfig):
    raise NotImplementedError("MoE layers are not ported to repro_torch yet "
                              "(ROADMAP.md §1)")
