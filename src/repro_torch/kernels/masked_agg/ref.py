"""Plain PyTorch versions of the masked cohort folds (FedHeN Alg. 1).

The ports of ``repro.kernels.masked_agg.ref``'s folds: the CPU path of
each fold, and the versions the CUDA kernels are held against on the card.
Contract of the dense fold:

    out[n] = acc[n] + sum_z gate(x[z, n]) * w[z, n],
    w[z, n] = mask[n] ? w_m[z] : w_rest[z],   gate(v) = v if w > 0 else 0

(the one-shot :func:`masked_agg_ref` starts from 0 and stores ``out`` in
``x.dtype``).  The gate is a select, never a multiply: a NaN client folded
at weight 0 must not poison the sum (NaN * 0 is NaN).
"""

from __future__ import annotations

import torch


def masked_agg_ref(x: torch.Tensor, mask: torch.Tensor, w_m: torch.Tensor,
                   w_rest: torch.Tensor) -> torch.Tensor:
    """One-shot masked sum of x (Z, N) (f32 or bf16) -> (N,) in x.dtype.

    f32 products and sums, one row at a time in z order from 0, each
    product and each sum rounded on its own; the f32 result is rounded to
    ``x.dtype`` once at the end."""
    out = torch.zeros(x.shape[1:], dtype=torch.float32, device=x.device)
    for z in range(x.shape[0]):
        wz = torch.where(mask, w_m[z], w_rest[z]).to(torch.float32)
        xz = torch.where(wz > 0, x[z].to(torch.float32), 0.0)
        out = out + xz * wz
    return out.to(x.dtype)


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


def _group_scales(scales_row: torch.Tensor, quant_block: int,
                  length: int) -> torch.Tensor:
    """One row's per-group scales repeated over their groups' elements."""
    return torch.repeat_interleave(scales_row, quant_block)[:length]


def masked_agg_acc_deq_ref(acc: torch.Tensor, q: torch.Tensor,
                           scales: torch.Tensor, mask: torch.Tensor,
                           w_m: torch.Tensor, w_rest: torch.Tensor, *,
                           quant_block: int) -> torch.Tensor:
    """acc (N,) f32 + masked sum of the int8 payload q (Z, N) times its
    per-group f32 scales (Z, N / quant_block) -> new (N,) f32.

    Row-streamed like :func:`masked_agg_acc_ref`: each row is dequantized
    (``q * scale``), gated by its weight (a NaN scale row at weight 0 adds
    nothing) and added in row order."""
    z, n = q.shape
    out = acc
    for row in range(z):
        xz = q[row].to(torch.float32) * _group_scales(scales[row],
                                                      quant_block, n)
        wz = torch.where(mask, w_m[row], w_rest[row]).to(torch.float32)
        xz = torch.where(wz > 0, xz, 0.0)
        out = out + xz * wz
    return out


def masked_scatter_acc_ref(acc: torch.Tensor, values: torch.Tensor,
                           scales, indices: torch.Tensor,
                           mask: torch.Tensor, w_m: torch.Tensor,
                           w_rest: torch.Tensor, *,
                           quant_block: int) -> torch.Tensor:
    """acc (N,) f32 += each row's compacted payload values (Z, k) (int8,
    bf16 or f32) times its per-group scales (Z, k / quant_block; ``None``
    = no dequant) scattered at the flat positions indices (Z, k) -> new
    (N,) f32.

    Row by row, one scatter-add per row (indices distinct within a row).
    The weight at each target is ``mask[idx] ? w_m[z] : w_rest[z]``; a
    zero weight gates the value before the add, and a row whose two
    weights are both 0 is zeroed first."""
    z, k = values.shape
    out = acc
    for row in range(z):
        v = values[row].to(torch.float32)
        if scales is not None:
            v = v * _group_scales(scales[row], quant_block, k)
        v = torch.where((w_m[row] > 0) | (w_rest[row] > 0), v, 0.0)
        idx = indices[row].to(torch.int64)
        w_at = torch.where(mask[idx], w_m[row], w_rest[row]).to(
            torch.float32)
        v = torch.where(w_at > 0, v, 0.0) * w_at
        out = out.index_add(0, idx, v)
    return out
