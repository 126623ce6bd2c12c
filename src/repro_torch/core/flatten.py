"""Static flat-buffer packing layout for the aggregation hot path.

The port of ``repro.core.flatten``.  The FedHeN server fold is a masked
reduction over every parameter of a cohort chunk, so the trainer packs each
trained client into one row of a contiguous ``(Z, n_flat)`` buffer and
folds the whole chunk with ONE kernel launch.

``FlatLayout`` assigns every leaf a contiguous, lane-aligned slice of one
flat vector.  Offsets are a pure function of (leaf order, leaf shapes,
align, total_multiple).  Leaf order is the reference's ``jax.tree.flatten``
order (:mod:`repro_torch.tree`) and leaf shapes are the reference's (conv
kernels HWIO), so both packages build the same layout — same ``n_flat``,
offsets and :attr:`FlatLayout.signature` — and a flat vector packed by one
unpacks in the other.

Alignment padding and the tail up to ``n_flat`` are zero in every packed
buffer, so they contribute exactly 0 to any weighted sum over it.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.tree import Tree, tree_flatten, tree_leaves, tree_unflatten

LANES = 128  # the reference's TPU lane width; kept so layouts match


class LeafSlot(NamedTuple):
    """Where one leaf lives inside the flat buffer (all static ints)."""
    offset: int          # start element in the flat vector
    size: int            # true element count (prod(shape))
    padded: int          # size rounded up to the lane alignment
    shape: Tuple[int, ...]
    dtype: torch.dtype   # dtype of the source leaf


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``"float32"`` (numpy's name, as JAX prints it)."""
    return str(dtype).replace("torch.", "")


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """Static packing plan: one slot per leaf, lane-aligned, fixed total."""
    treedef: Tree
    slots: Tuple[LeafSlot, ...]
    n_flat: int          # total flat length (multiple of ``total_multiple``)
    align: int
    total_multiple: int

    @property
    def n_leaves(self) -> int:
        return len(self.slots)

    @property
    def n_params(self) -> int:
        """True parameter count (excludes alignment padding)."""
        return sum(s.size for s in self.slots)

    @property
    def signature(self) -> str:
        """Stable fingerprint of the packing plan (slot offsets, shapes,
        dtypes) — the same string the reference computes for the same
        layout."""
        desc = repr([(s.offset, s.size, s.padded, s.shape,
                      dtype_name(s.dtype)) for s in self.slots])
        return hashlib.sha1(desc.encode()).hexdigest()[:16]

    def stream_bytes(self, dtype: torch.dtype = torch.float32, *,
                     quant_block: int = 0) -> int:
        """Bytes one packed client occupies at the given stream dtype, with
        the f32 scale sidecar (one scale per ``quant_block`` elements) of
        an int8 wire."""
        n = self.n_flat * torch.empty((), dtype=dtype).element_size()
        if quant_block and dtype == torch.int8:
            n += (self.n_flat // quant_block) * 4
        return n


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m if m > 1 else n


def build_layout(tree: Tree, *, align: int = LANES,
                 total_multiple: int = 0) -> FlatLayout:
    """Assign every leaf of ``tree`` an aligned slice of one flat vector.

    ``tree`` may hold tensors on any device, ``meta`` tensors included:
    only shapes and dtypes are read.  ``total_multiple`` rounds the total
    length up (the trainer passes ``agg_block_n``, as the reference does,
    so ``n_flat`` matches it).
    """
    leaves, treedef = tree_flatten(tree)
    slots = []
    offset = 0
    for x in leaves:
        shape = tuple(int(d) for d in x.shape)
        size = 1
        for d in shape:
            size *= d
        padded = _round_up(size, align)
        slots.append(LeafSlot(offset, size, padded, shape, x.dtype))
        offset += padded
    n_flat = _round_up(offset, max(total_multiple, 1))
    n_flat = max(n_flat, max(total_multiple, align, 1))
    return FlatLayout(treedef=treedef, slots=tuple(slots), n_flat=n_flat,
                      align=align, total_multiple=total_multiple)


def _structure_key(treedef: Tree) -> Any:
    """A hashable form of a treedef: two trees with the same key have the
    same leaf order and nesting (dict key order does not matter)."""
    if isinstance(treedef, dict):
        return ("dict", tuple((k, _structure_key(treedef[k]))
                              for k in sorted(treedef)))
    if isinstance(treedef, (list, tuple)):
        return (type(treedef).__name__,
                tuple(_structure_key(v) for v in treedef))
    return None


_LAYOUT_CACHE: Dict[Any, FlatLayout] = {}


def layout_of(tree: Tree, *, align: int = LANES, total_multiple: int = 0,
              stacked: bool = False) -> FlatLayout:
    """Cached :func:`build_layout`, keyed on the tree's structure, every
    leaf's shape and dtype, ``align`` and ``total_multiple``: the same
    signature returns the same :class:`FlatLayout` object.

    ``stacked=True`` strips the leading cohort axis of every leaf first (a
    layout for one client from a stacked chunk); the stripped leaves are
    ``meta`` tensors, so nothing is allocated."""
    leaves, treedef = tree_flatten(tree)
    sig = [(tuple(int(d) for d in x.shape[1 if stacked else 0:]), x.dtype)
           for x in leaves]
    key = (_structure_key(treedef), tuple(sig), align, total_multiple)
    hit = _LAYOUT_CACHE.get(key)
    if hit is None:
        if stacked:
            tree = tree_unflatten(treedef, [
                torch.empty(shape, dtype=dtype, device="meta")
                for shape, dtype in sig])
        hit = build_layout(tree, align=align, total_multiple=total_multiple)
        _LAYOUT_CACHE[key] = hit
    return hit


# ---------------------------------------------------------------------------
# Pack / unpack
# ---------------------------------------------------------------------------

def pack_into(layout: FlatLayout, tree: Tree, out: torch.Tensor) -> torch.Tensor:
    """Write ONE model's leaves into their slots of the ``(n_flat,)`` row
    ``out`` (cast to ``out.dtype``).  Padding is not touched: the caller
    allocates ``out`` zeroed once and reuses it."""
    for x, slot in zip(tree_leaves(tree), layout.slots):
        out[slot.offset:slot.offset + slot.size].copy_(x.reshape(-1))
    return out


def pack(layout: FlatLayout, tree: Tree, *,
         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Pack ONE model tree into a zero-padded ``(n_flat,)`` vector."""
    device = tree_leaves(tree)[0].device
    out = torch.zeros((layout.n_flat,), dtype=dtype, device=device)
    return pack_into(layout, tree, out)


def pack_stacked(layout: FlatLayout, tree: Tree, *,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Pack a stacked tree (leaves ``(Z, *slot.shape)``) into one
    zero-padded ``(Z, n_flat)`` buffer."""
    leaves = tree_leaves(tree)
    z = leaves[0].shape[0]
    out = torch.zeros((z, layout.n_flat), dtype=dtype,
                      device=leaves[0].device)
    for x, slot in zip(leaves, layout.slots):
        out[:, slot.offset:slot.offset + slot.size].copy_(x.reshape(z, -1))
    return out


def unpack(layout: FlatLayout, flat: torch.Tensor, *,
           cast: bool = True) -> Tree:
    """Inverse of :func:`pack`.  Leaves are views into ``flat`` (cast to
    their slot dtypes when ``cast`` — a no-op for f32 leaves of an f32
    vector)."""
    leaves = []
    for slot in layout.slots:
        x = flat[slot.offset:slot.offset + slot.size].view(slot.shape)
        leaves.append(x.to(slot.dtype) if cast else x)
    return tree_unflatten(layout.treedef, leaves)


def unpack_stacked(layout: FlatLayout, xz: torch.Tensor) -> Tree:
    """The stacked tree of a packed ``(Z, n_flat)`` buffer: leaf ``i`` is
    the view ``xz[:, offset:offset + size]`` shaped ``(Z, *slot.shape)``
    (rows ``n_flat`` elements apart; no copy, no cast)."""
    z = xz.shape[0]
    leaves = [xz[:, s.offset:s.offset + s.size].view((z,) + s.shape)
              for s in layout.slots]
    return tree_unflatten(layout.treedef, leaves)


def pack_mask(layout: FlatLayout, mask_tree: Tree,
              device: Any = "cpu") -> torch.Tensor:
    """Lower the index-set-M mask tree (leaves: bools or bool tensors
    broadcastable to their slot's shape) to one ``(n_flat,)`` bool vector.
    Padding lanes are False."""
    out = torch.zeros((layout.n_flat,), dtype=torch.bool, device=device)
    for m, slot in zip(tree_leaves(mask_tree), layout.slots):
        m = torch.as_tensor(m, dtype=torch.bool, device=device)
        out[slot.offset:slot.offset + slot.size] = \
            m.expand(slot.shape).reshape(-1)
    return out


# ---------------------------------------------------------------------------
# Memory-budget chunk heuristic
# ---------------------------------------------------------------------------

# A training client's round working set is roughly this many copies of its
# packed parameter vector (params, grads, update temps, activation slack,
# all f32) plus ONE stream-buffer copy at ``agg_stream_dtype`` — the
# reference's constant.
CLIENT_FOOTPRINT_MULTIPLIER = 6.0


def auto_cohort_chunk(layout: FlatLayout, *, budget_bytes: float, k: int,
                      stream_dtype: torch.dtype = torch.float32,
                      quant_block: int = 0,
                      multiplier: float = CLIENT_FOOTPRINT_MULTIPLIER) -> int:
    """Largest chunk whose per-client footprint x chunk fits the budget:
    ``clamp(budget / per_client, 1, k)``.  An int8 wire's scale sidecar
    (``quant_block``) is part of the stream copy."""
    per_client = (layout.stream_bytes(torch.float32) * (multiplier - 1.0)
                  + layout.stream_bytes(stream_dtype,
                                        quant_block=quant_block))
    chunk = int(budget_bytes // max(per_client, 1.0))
    return max(1, min(chunk, max(k, 1)))
