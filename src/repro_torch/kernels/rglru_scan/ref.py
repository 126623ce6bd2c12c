"""Plain PyTorch version of the RG-LRU linear-recurrence kernel.

    y_t = a_t * y_{t-1} + b_t        (elementwise, per channel)

The port of ``repro.kernels.rglru_scan.ref``: sequential, the dumbest
possible version.  Each product and each sum is its own f32 operation
(PyTorch does not fuse them), which is what K6 computes with
``__fmul_rn`` / ``__fadd_rn``, so the two agree bitwise.
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
