"""Plain SGD with global-norm clipping — the paper's client optimizer
(eta = 0.1, clip 10; Appendix A) — plus the reference's AdamW and cosine
schedule (beyond the paper; no module calls them).  The port of
``repro.optim.sgd``.

A gradient leaf may be ``None``: PyTorch leaves ``.grad`` unset for a
parameter the loss does not touch (``loss_simple`` touches only M), where
JAX returns zeros.  Every function here treats ``None`` as a zero
gradient, so such a parameter comes back unchanged.

SCAFFOLD adds a correction to every gradient, so a leaf PyTorch left
``None`` gets the correction alone.  The trainer hands such leaves over
as a second tree, ``extra``: their squares are summed apart and added to
the first tree's sum, so an all-zero correction (SCAFFOLD's first round)
leaves the norm, and so the round, bit for bit as without it.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.tree import Tree, tree_leaves, tree_map


def _sum_sq(tree: Tree) -> Optional[torch.Tensor]:
    sums = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)
            if x is not None]
    return torch.sum(torch.stack(sums)) if sums else None


def global_norm(tree: Tree, extra: Optional[Tree] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every (non-``None``) leaf, in f32;
    ``extra``'s sum of squares (if it has any leaf) is added to
    ``tree``'s."""
    total = _sum_sq(tree)
    more = _sum_sq(extra) if extra is not None else None
    if more is not None:
        total = more if total is None else total + more
    if total is None:
        return torch.zeros(())
    return torch.sqrt(total)


def clip_by_global_norm(grads: Tree, max_norm: float,
                        extra: Optional[Tree] = None
                        ) -> Tuple[Tree, torch.Tensor]:
    """Scale ``grads`` (and ``extra``, where its leaf stands in for a
    ``None`` one) to a joint global norm of at most ``max_norm``."""
    norm = global_norm(grads, extra)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    if extra is not None:
        grads = tree_map(lambda g, e: e if g is None else g, grads, extra)
    return tree_map(lambda g: None if g is None
                    else (g.float() * scale).to(g.dtype), grads), norm


def sgd_update(params: Tree, grads: Tree, lr: float,
               clip_norm: Optional[float] = None,
               extra: Optional[Tree] = None) -> Tree:
    """w <- w - lr * clip(g).  Arithmetic in f32, stored in param dtype; a
    ``None`` gradient leaves its parameter as it is, unless ``extra`` has
    a leaf there, which then serves as that parameter's gradient (its
    square counted after ``grads``' in the clip's norm)."""
    if clip_norm:
        grads, _ = clip_by_global_norm(grads, clip_norm, extra)
    elif extra is not None:
        grads = tree_map(lambda g, e: e if g is None else g, grads, extra)
    return tree_map(
        lambda w, g: w if g is None
        else (w.float() - lr * g.float()).to(w.dtype), params, grads)


# ---------------------------------------------------------------------------
# AdamW (beyond the paper; the reference's centralized runs)
# ---------------------------------------------------------------------------

class AdamState(NamedTuple):
    step: torch.Tensor   # 0-d int32
    mu: Tree             # f32, shaped like the params
    nu: Tree


def adam_init(params: Tree) -> AdamState:
    """Zero moments in f32 (also for bf16 params) and step 0, on the
    params' device."""
    zeros = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                           device=x.device), params)
    device = tree_leaves(params)[0].device
    return AdamState(torch.zeros((), dtype=torch.int32, device=device),
                     zeros, tree_map(torch.clone, zeros))


def adam_update(params: Tree, grads: Tree, state: AdamState, lr: float, *,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                weight_decay: float = 0.0,
                clip_norm: Optional[float] = None) -> Tuple[Tree, AdamState]:
    """One AdamW step: ``(new params, new state)``.  Arithmetic in f32,
    params stored in their dtype.  ``b1 ** t`` and ``b2 ** t`` are f32
    tensor powers, as the reference computes them (a Python float power
    would be f64).  A ``None`` gradient counts as zero."""
    if clip_norm:
        grads, _ = clip_by_global_norm(grads, clip_norm)
    step = state.step + 1
    t = step.to(torch.float32)
    g32 = lambda g, like: (torch.zeros_like(like) if g is None
                           else g.to(torch.float32))
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g32(g, m),
                  state.mu, grads)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g32(g, v)),
                  state.nu, grads)
    bias1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=t.device), t)
    bias2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=t.device), t)

    def upd(w, m, v):
        delta = (m / bias1) / (torch.sqrt(v / bias2) + eps)
        if weight_decay:
            delta = delta + weight_decay * w.to(torch.float32)
        return (w.to(torch.float32) - lr * delta).to(w.dtype)

    return tree_map(upd, params, mu, nu), AdamState(step, mu, nu)


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

def cosine_schedule(base_lr: float, warmup: int, total: int):
    """``lr(step)``: linear warm-up over ``warmup`` steps, then a cosine
    decay to 0 at ``total``; a 0-d f32 tensor, computed in f32 as the
    reference computes it."""
    def lr(step) -> torch.Tensor:
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return lr
