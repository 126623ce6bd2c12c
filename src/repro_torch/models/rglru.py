"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

The port of ``repro.models.rglru``.  Block layout:

    h -> W_in -> causal depthwise conv1d(width 4) -> RG-LRU -> * gelu(W_gate h) -> W_out

RG-LRU recurrence (diagonal, per channel):

    r_t = sigmoid(w_r * x_t + b_r)              recurrence gate
    i_t = sigmoid(w_i * x_t + b_i)              input gate
    log a_t = -c * softplus(lam) * r_t          c = 8
    y_t = a_t * y_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill runs the gates and the recurrence through
``kernels.rglru_scan.ops.lru_scan_gated`` (K6's gated entry on the card,
the gates then the sequential scan on the CPU) — the function the
reference's prefill gives its Pallas kernel on a TPU (``ops.lru_scan`` in
place of its associative scan, with the gates fused in front by XLA).
K6 has no backward, so training (:func:`apply_rglru_train`) runs
:func:`_gates` and :func:`linear_scan`, plain PyTorch under autograd,
with the reference's combine.  Decode is the single-step
recurrence carrying ``(y, conv window)`` state, updated in place.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rglru_scan import ops
from repro_torch.models import common
from repro_torch.models.mlp import gelu

_C = 8.0


def init_rglru(generator: torch.Generator, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    dr = cfg.resolved_d_rnn
    tw = cfg.lru_temporal_width
    dt = cfg.torch_param_dtype()
    dev = generator.device
    # lam such that a^c spans ~(0.9, 0.999), as in the Griffin paper
    u = 0.9 + (0.999 - 0.9) * torch.rand((dr,), generator=generator,
                                         device=dev)
    lam = torch.log(torch.expm1(-torch.log(u) / _C))  # softplus^-1(-log u / c)
    return {
        "w_in": common.dense_init(generator, (d, dr), dtype=dt),
        "w_gate": common.dense_init(generator, (d, dr), dtype=dt),
        "w_out": common.dense_init(generator, (dr, d), fan_in=dr, dtype=dt),
        "conv": common.dense_init(generator, (tw, dr), fan_in=tw, dtype=dt),
        **{k: torch.zeros((dr,), dtype=torch.float32, device=dev)
           for k in ("w_r", "b_r", "w_i", "b_i")},
        "lam": lam,
    }


def _gates(p: dict, x: torch.Tensor):
    """(a, b) of the recurrence in f32.  Softplus is ``logaddexp(x, 0)``,
    as ``jax.nn.softplus`` (``F.softplus`` switches to ``x`` above 20)."""
    xf = x.float()
    r = torch.sigmoid(p["w_r"] * xf + p["b_r"])
    i = torch.sigmoid(p["w_i"] * xf + p["b_i"])
    lam = p["lam"]
    log_a = -_C * torch.logaddexp(lam, torch.zeros_like(lam)) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (i * xf)
    return a, b


def lru_scan(p: dict, x: torch.Tensor,
             y0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The recurrence over (B, S, Dr) with its gates, through
    ``ops.lru_scan_gated`` (K6's gated entry on the card; on the CPU
    :func:`_gates`' arithmetic, then the sequential scan); y0 is folded
    into the first step, ``y_1 = a_1 y_0 + b_1``.  Returned in
    ``x.dtype``."""
    lam = p["lam"]
    c = -_C * torch.logaddexp(lam, torch.zeros_like(lam))
    return ops.lru_scan_gated(x, p["w_r"], p["b_r"], p["w_i"], p["b_i"], c,
                              None if y0 is None else y0.float())


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``y_t = a_t * y_{t-1} + b_t`` along axis 1 from ``y_0 = 0``,
    differentiable: the reference's ``associative_scan`` combine
    ``(a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)`` in a log-depth doubling
    scan.  ceil(log2 S) steps of whole-tensor ops keep autograd's graph
    and the card's launches at 2 log2 S per layer, where the sequential
    loop would take S of each; the sums group differently from XLA's
    scan, so the two agree to f32 rounding, not bitwise."""
    s = a.shape[1]
    d = 1
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b


def _causal_conv(p: dict, x: torch.Tensor,
                 window: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv, width tw.  window: (B, tw-1, Dr) history."""
    w = p["conv"].to(x.dtype)                       # (tw, Dr)
    tw, s = w.shape[0], x.shape[1]
    if window is None:
        pad = torch.zeros((x.shape[0], tw - 1, x.shape[-1]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = window.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                 # (B, S + tw - 1, Dr)
    out = xp[:, 0:s] * w[0]
    for i in range(1, tw):
        out = out + xp[:, i:i + s] * w[i]
    return out


def apply_rglru(p: dict, h_in: torch.Tensor, cfg: ModelConfig,
                return_state: bool = False):
    """Prefill path.  h_in: (B, S, D) -> (B, S, D).

    ``return_state=True`` also returns the decode cache: the last step's
    ``y`` in f32 (rounded through ``x.dtype`` first, as the reference's
    is) and the last tw - 1 steps of the pre-conv input."""
    x = torch.matmul(h_in, p["w_in"].to(h_in.dtype))
    g = torch.matmul(h_in, p["w_gate"].to(h_in.dtype))
    y = lru_scan(p, _causal_conv(p, x))
    out = torch.matmul(y * gelu(g), p["w_out"].to(h_in.dtype))
    if return_state:
        tw = cfg.lru_temporal_width
        state = {"y": y[:, -1].float().clone(),
                 "conv": x[:, -(tw - 1):].to(cfg.torch_compute_dtype()
                                             ).clone()}
        return out, state
    return out


def apply_rglru_train(p: dict, h_in: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    """Training path.  h_in: (B, S, D) -> (B, S, D), differentiable: the
    recurrence through :func:`linear_scan`, never K6."""
    x = torch.matmul(h_in, p["w_in"].to(h_in.dtype))
    g = torch.matmul(h_in, p["w_gate"].to(h_in.dtype))
    a, b = _gates(p, _causal_conv(p, x))
    y = linear_scan(a, b).to(x.dtype)
    return torch.matmul(y * gelu(g), p["w_out"].to(h_in.dtype))


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_rglru_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    dr = cfg.resolved_d_rnn
    tw = cfg.lru_temporal_width
    return {"y": torch.zeros((batch, dr), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, tw - 1, dr),
                                dtype=cfg.torch_compute_dtype(),
                                device=device)}


def apply_rglru_decode(p: dict, h_in: torch.Tensor, cache: dict,
                       cfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    """One step.  h_in: (B, 1, D) -> ((B, 1, D), cache), the cache updated
    in place."""
    x = torch.matmul(h_in, p["w_in"].to(h_in.dtype))
    g = torch.matmul(h_in, p["w_gate"].to(h_in.dtype))
    conv = cache["conv"]
    xc = _causal_conv(p, x, window=conv)            # (B, 1, Dr)
    a, b = _gates(p, xc[:, 0])
    y = a * cache["y"] + b                          # (B, Dr) f32
    out = y[:, None].to(h_in.dtype) * gelu(g)
    out = torch.matmul(out, p["w_out"].to(out.dtype))
    conv.copy_(torch.cat([conv, x.to(conv.dtype)], dim=1)[:, 1:])
    cache["y"].copy_(y)
    return out, cache
