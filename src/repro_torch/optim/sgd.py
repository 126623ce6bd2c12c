"""Plain SGD with global-norm clipping — the paper's client optimizer
(eta = 0.1, clip 10; Appendix A).  The port of ``repro.optim.sgd``.

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

from typing import Optional, Tuple

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
