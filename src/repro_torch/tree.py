"""Parameter trees: nested dicts and lists of tensors, in JAX's leaf order.

The reference keeps parameters as pytrees such as
``params["stage1"][0]["conv1"]``.  The port keeps the same nesting, and
these helpers walk it in ``jax.tree.flatten`` order — dict keys sorted,
then list index — so leaf ``i`` of either package is the same parameter,
and a flat layout built by either package has the same offsets.

``None`` is a leaf here (it stands for a missing gradient), and so is a
tuple whose class sets ``tree_leaf = True`` (``launch.sharding``'s
``PartitionSpec``, a tuple as JAX's is and a leaf of a spec tree as
JAX's is).
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

Tree = Any


def _is_node(tree: Tree) -> bool:
    return isinstance(tree, (list, tuple)) and not getattr(
        tree, "tree_leaf", False)


def _children(tree: Tree):
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if _is_node(tree):
        return list(tree)
    return None


def tree_leaves(tree: Tree) -> List[Any]:
    """Leaves in JAX order (sorted dict keys, then list index)."""
    kids = _children(tree)
    if kids is None:
        return [tree]
    out: List[Any] = []
    for k in kids:
        out.extend(tree_leaves(k))
    return out


def tree_leaves_with_keys(tree: Tree, keys: Tuple[str, ...] = ()
                          ) -> List[Tuple[Tuple[str, ...], Any]]:
    """``(keys, leaf)`` in JAX order: a dict key as ``str(key)``, a list
    or tuple index ``i`` as ``"#i"`` (the reference's ``_path_keys``)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in tree_leaves_with_keys(tree[k], keys + (str(k),))]
    if _is_node(tree):
        return [kv for i, t in enumerate(tree)
                for kv in tree_leaves_with_keys(t, keys + (f"#{i}",))]
    return [(keys, tree)]


def tree_flatten(tree: Tree) -> Tuple[List[Any], Tree]:
    """``(leaves, treedef)``; the treedef is the tree with ``None`` leaves."""
    return tree_leaves(tree), tree_map(lambda _: None, tree)


def tree_unflatten(treedef: Tree, leaves) -> Tree:
    """Inverse of :func:`tree_flatten`."""
    it = iter(leaves)
    out = _rebuild(treedef, it)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the treedef has slots")
    return out


_END = object()


def _rebuild(treedef: Tree, it: Iterator) -> Tree:
    if isinstance(treedef, dict):
        return {k: _rebuild(treedef[k], it) for k in sorted(treedef)}
    if _is_node(treedef):
        return type(treedef)(_rebuild(k, it) for k in treedef)
    leaf = next(it, _END)
    if leaf is _END:
        raise ValueError("fewer leaves than the treedef has slots")
    return leaf


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` leafwise over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if _is_node(tree):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)
