"""Index set M (FedHeN Assumption 2.1) as broadcastable mask trees.

The port of ``repro.core.masking``: a mask tree has the parameter tree's
structure; a leaf is a Python bool marking the whole leaf in or out of M,
or, for a decoder's period-stacked leaf (leading axis ``n_periods``), a
bool tensor of shape ``(n_periods, 1, ...)`` true for the periods below
``exit_period``.  ``flatten.pack_mask`` lowers either to one flat
bitvector.  The trainer keeps one more form, built once on its device:
``flatten.unpack(layout, flat_mask, cast=False)``, a tree of full-shape
bool views of that bitvector — the per-leaf masks of the tree engine.
"""

from __future__ import annotations

import torch

from repro_torch.models import common, resnet
from repro_torch.tree import Tree, tree_leaves, tree_map

# the decoder's subtrees inside M besides the prefix periods
LM_SIMPLE_KEYS = ("embed", "frontend_proj", "exit_norm")


def resnet_subnet_mask(params: Tree) -> Tree:
    """M for the ResNet: stem + stage1 + stage2 + exit head
    (:func:`repro_torch.models.resnet.subnet_mask`)."""
    return resnet.subnet_mask(params)


def _period_mask(x: torch.Tensor, kp: int) -> torch.Tensor:
    m = torch.arange(x.shape[0], device=x.device) < kp
    return m.reshape((x.shape[0],) + (1,) * (x.dim() - 1))


def transformer_subnet_mask(params: Tree, cfg) -> Tree:
    """M for the decoder zoo: embedding + frontend projector + the first
    ``exit_period`` periods + the exit head's norm (the tied unembedding
    is the embedding).  ``rem``, ``final_norm`` and an untied ``unembed``
    are out."""
    mask = {}
    for name, sub in params.items():
        if name == "periods":
            mask[name] = tuple(
                tree_map(lambda x: _period_mask(x, cfg.exit_period), s)
                for s in sub)
        else:
            mask[name] = tree_map(
                lambda _, keep=name in LM_SIMPLE_KEYS: keep, sub)
    return mask


def apply_mask(mask: Tree, tree: Tree) -> Tree:
    """Zero the complement of M (isolates ``[w]_M``)."""
    return tree_map(lambda m, x: torch.where(
        torch.as_tensor(m, dtype=torch.bool, device=x.device), x,
        torch.zeros((), dtype=x.dtype, device=x.device)), mask, tree)


def leaf_mask_size(m, x: torch.Tensor) -> int:
    """Number of elements of leaf ``x`` inside M under its mask leaf."""
    if isinstance(m, torch.Tensor):
        return int(m.expand(x.shape).sum())
    return x.numel() if m else 0


def mask_size(mask: Tree, params: Tree) -> int:
    """Number of scalar parameters inside M."""
    return sum(leaf_mask_size(m, x)
               for m, x in zip(tree_leaves(mask), tree_leaves(params)))


def extract_simple(params: Tree, cfg) -> Tree:
    """The simple model's own (smaller) parameter tree, consumable by
    ``transformer.forward_simple``: period stacks cut to ``exit_period``
    (views), the complex-only subtrees dropped."""
    kp = cfg.exit_period
    out = {}
    for name, sub in params.items():
        if name == "periods":
            out[name] = tuple(tree_map(lambda x: x[:kp], s) for s in sub)
        elif name in LM_SIMPLE_KEYS:
            out[name] = sub
    return out


def embed_simple(simple: Tree, complex_params: Tree,
                 cfg) -> Tree:
    """Write a simple tree back into the complex one (``[w_c]_M := w_s``);
    returns a new tree, ``complex_params`` is not modified."""
    kp = cfg.exit_period
    out = dict(complex_params)
    for name, sub in simple.items():
        if name == "periods":
            out[name] = tuple(
                tree_map(lambda a, c: torch.cat([a.to(c.dtype), c[kp:]]),
                         s_stk, c_stk)
                for s_stk, c_stk in zip(sub, complex_params["periods"]))
        else:
            out[name] = sub
    return out


def tree_isfinite(tree: Tree) -> torch.Tensor:
    """0-d bool tensor: every floating leaf fully finite (the paper's
    NaN-device check).  Stays on the tree's device: no host sync.

    DTensor leaves are checked on every rank's shard: each rank's count of
    non-finite local leaves is summed over each dim of their mesh (an
    all-reduce), so a client is valid only where every shard is finite,
    and every rank gets the same flag (a plain tensor)."""
    leaves = [x for x in tree_leaves(tree) if x.is_floating_point()]
    if not leaves:
        return torch.tensor(True)
    local = [x.to_local() if common.is_dtensor(x) else x for x in leaves]
    ok = torch.stack([torch.isfinite(x).all() for x in local]).all()
    meshes = {id(x.device_mesh): x.device_mesh for x in leaves
              if common.is_dtensor(x)}
    if not meshes:
        return ok
    import torch.distributed as dist
    bad = (~ok).to(torch.float32)
    for mesh in meshes.values():
        for i in range(mesh.ndim):
            if mesh.size(i) > 1:
                dist.all_reduce(bad, group=mesh.get_group(i))
    return bad == 0


def where_mask(mask: Tree, a: Tree, b: Tree) -> Tree:
    """Leafwise ``mask ? a : b`` (mask leaves: bools or bool tensors
    broadcastable to their leaf)."""
    return tree_map(lambda m, x, y: torch.where(
        torch.as_tensor(m, dtype=torch.bool, device=x.device), x, y),
        mask, a, b)
