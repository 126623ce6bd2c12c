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

from typing import Tuple

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


def masked_agg_fold_ref(acc: torch.Tensor, x: torch.Tensor,
                        mask: torch.Tensor, w_m: torch.Tensor,
                        w_rest: torch.Tensor,
                        leaves: torch.Tensor) -> torch.Tensor:
    """acc (M,) f32 plus, for every leaf row ``(x_off, size, out_off)`` of
    ``leaves`` (L, 3), the one-shot masked sum of the leaf's columns of x
    (Z, *) f32 at the mask's (M,) entries from ``out_off``, added to acc
    there -> new (M,) f32 (elements no leaf covers are acc's).

    The tree engine's fold: per leaf, ``acc + masked_agg_ref(leaf)``."""
    out = acc.clone()
    for x_off, size, out_off in leaves.tolist():
        o = slice(out_off, out_off + size)
        out[o] += masked_agg_ref(x[:, x_off:x_off + size], mask[o], w_m,
                                 w_rest)
    return out


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


def scatter_bounds_ref(indices: torch.Tensor, w_m: torch.Tensor,
                       w_rest: torch.Tensor, n: int, span: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The scatter fold's first pass: ``(start, end, live)``.

    start, end (Z, n_spans) int32 with ``n_spans = ceil(n / span)``: row
    z's entries in span s are ``[start[z, s], end[z, s])``, an empty run
    ``[0, 0)`` where it has none, and everywhere for a row whose two
    weights are both 0.  live: the spans where a live row has an entry,
    ascending (the kernel lists them in no order).

    Built as the kernel builds it, one entry at a time: an entry in span
    ``here`` (an index below 0 counts in span 0, one at or past n in no
    span) whose predecessor lies in another span writes the run's start,
    one whose successor does the run's end."""
    z, k = indices.shape
    n_spans = -(-n // span)
    p = indices.to(torch.int64)
    here = torch.where(p < 0, 0, torch.where(p >= n, n_spans, p // span))
    start = torch.zeros((z, n_spans), dtype=torch.int32)
    end = torch.zeros((z, n_spans), dtype=torch.int32)
    live = torch.zeros((n_spans,), dtype=torch.bool)
    j = torch.arange(k, dtype=torch.int32)
    for row in range(z):
        if not (w_m[row] > 0 or w_rest[row] > 0) or k == 0:
            continue
        h = here[row]
        prev = torch.cat([h.new_full((1,), -1), h[:-1]])
        nxt = torch.cat([h[1:], h.new_full((1,), n_spans)])
        opens = (h != prev) & (h < n_spans)
        closes = (h != nxt) & (h < n_spans)
        start[row, h[opens]] = j[opens]
        end[row, h[closes]] = j[closes] + 1
        live[h[opens]] = True
    return start, end, torch.nonzero(live).flatten()
