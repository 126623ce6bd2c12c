"""Plain PyTorch version of the masked cohort aggregation (FedHeN Alg. 1).

The port of ``repro.kernels.masked_agg.ref.masked_agg_acc_ref``: the CPU
path of the fold, and the version the CUDA kernel is held against on the
card.  Contract:

    out[n] = acc[n] + sum_z gate(x[z, n]) * w[z, n],
    w[z, n] = mask[n] ? w_m[z] : w_rest[z],   gate(v) = v if w > 0 else 0

The gate is a select, never a multiply: a NaN client folded at weight 0
must not poison the sum (NaN * 0 is NaN).
"""

from __future__ import annotations

import torch


def masked_agg_acc_ref(acc: torch.Tensor, x: torch.Tensor,
                       mask: torch.Tensor, w_m: torch.Tensor,
                       w_rest: torch.Tensor) -> torch.Tensor:
    """acc (N,) f32 + masked sum of x (Z, N) (f32 or bf16) -> new (N,) f32.

    Row-streamed over Z like the reference: each row adds its own gated,
    weighted term to the running sum, in row order."""
    out = acc
    for z in range(x.shape[0]):
        wz = torch.where(mask, w_m[z], w_rest[z]).to(torch.float32)
        xz = torch.where(wz > 0, x[z].to(torch.float32), 0.0)
        out = out + xz * wz
    return out
