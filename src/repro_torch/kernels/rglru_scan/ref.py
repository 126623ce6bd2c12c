"""Plain PyTorch versions of the RG-LRU linear-recurrence kernel.

    y_t = a_t * y_{t-1} + b_t        (elementwise, per channel)

The port of ``repro.kernels.rglru_scan.ref``: sequential, the dumbest
possible version.  Each product and each sum is its own f32 operation
(PyTorch does not fuse them), which is what K6 computes with
``__fmul_rn`` / ``__fadd_rn``, so the two agree bitwise.
``lru_scan_gated_ref`` is the gated entry's plain version: the recurrent
layer's gates (a copy of ``models/rglru._gates``, with
``c = -8 softplus(lam)`` from the caller), then the scan.
"""

from __future__ import annotations

from typing import Optional

import torch


def lru_scan_ref(a: torch.Tensor, b: torch.Tensor,
                 y0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a, b: (B, S, D) -> y: (B, S, D) in ``a.dtype``; the carry is f32,
    from 0 (or ``y0``, (B, D))."""
    bsz, s, d = a.shape
    y = (torch.zeros((bsz, d), dtype=torch.float32, device=a.device)
         if y0 is None else y0.float())
    out = torch.empty_like(a)
    for t in range(s):
        y = a[:, t].float() * y + b[:, t].float()
        out[:, t] = y
    return out


def lru_scan_gated_ref(x: torch.Tensor, w_r: torch.Tensor,
                       b_r: torch.Tensor, w_i: torch.Tensor,
                       b_i: torch.Tensor, c: torch.Tensor,
                       y0: Optional[torch.Tensor] = None,
                       y_last: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """x (B, S, D); w_r, b_r, w_i, b_i, c (D,) f32; y0 (B, D) or None ->
    y (B, S, D) in ``x.dtype``: the gates in f32, y0 folded into the first
    step (``b_1 += a_1 y0``), the scan from 0, one rounding to x's
    dtype.  ``y_last`` (B, D) f32, if given, receives the f32 scan's last
    row before that rounding: the state a run on the next rows starts
    from."""
    xf = x.float()
    r = torch.sigmoid(w_r * xf + b_r)
    i = torch.sigmoid(w_i * xf + b_i)
    log_a = c * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (i * xf)
    if y0 is not None:
        b[:, 0] = b[:, 0] + a[:, 0] * y0.float()
    y = lru_scan_ref(a, b)
    if y_last is not None:
        y_last.copy_(y[:, -1])
    return y.to(x.dtype)
