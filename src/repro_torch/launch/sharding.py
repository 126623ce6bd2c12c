"""Divisibility-aware sharding policy: the port of ``repro.launch.sharding``.

Two halves, as in the reference:

* **Activations** — model code annotates tensors with logical axis names
  (``policy.constrain(x, ("batch", "seq", "heads", None))``); MeshPolicy
  resolves each name through its rules, dropping any assignment that does
  not divide the dimension or would reuse a mesh axis twice.  On one
  device the default no-op Policy is used instead.

* **Parameters / caches** — ``param_specs`` and ``cache_specs`` walk the
  trees and classify leaves by their key path (wq/wk/wv/wo, mlp up/down,
  MoE experts, recurrent states, KV caches...), producing a
  :class:`PartitionSpec` tree.  ``bytes_per_chip`` sizes a tree under
  those specs.

Per-arch quirks are driven by the config (``attn_shard``): ``replicate``
(heads do not divide the 16-way model axis), ``head_dim`` (llava 56H/8kv:
shard the head dim), and the reference's perf variants ``seq2d`` /
``dp2d`` / ``seq2d_fsdp``.  MoE experts go over ``model`` on their experts
axis where it divides, else on ``expert_ffn``; ``shard_experts_2d``
(kimi-k2): ``expert_ffn`` over ``data`` as well.  The spec arithmetic is
the reference's, line for line, so the port's specs equal its specs on
every config of the zoo at both production mesh shapes.

Two pieces replace the reference's JAX-only ones:

* :func:`to_placements` (for ``to_named``) turns a spec into DTensor
  placements over a mesh: ``Shard(d)`` on each mesh dim that tensor dim
  ``d`` names, ``Replicate()`` on the others.  A dim named by ("pod",
  "data") is ``Shard(d)`` on both, pod major, as JAX splits it.
* :meth:`MeshPolicy.constrain` is the reference's
  ``with_sharding_constraint``: on a DTensor it is a ``redistribute`` to
  the resolved spec's placements, which is what GSPMD inserts there
  (a ``Partial`` sum becomes an all-reduce, a replicated tensor is sliced
  where the spec shards it).  It is the identity on ``meta`` tensors (the
  dry-runs on a :class:`MeshShape`) and on a plain tensor whose spec
  shards over data or pod axes or axes of size 1 (each rank already holds
  its share; the cohort-sharded round in ``launch/steps.py`` takes each
  rank's clients).  A plain tensor with values whose spec shards over a
  model axis larger than 1 raises ``TypeError``: it should have been a
  DTensor, and computing on it would silently give one rank's share.

**A live model axis (tensor parallelism).**  Over a ``DeviceMesh`` whose
model axis is larger than 1 the steps take parameters as DTensors placed
by :func:`param_specs` (:func:`distribute_params`, a cohort by
:func:`cohort_specs` with :func:`distribute_cohort`), and the models run
on them: plain PyTorch ops under DTensor's sharding propagation, every
hand-written kernel and the MoE block's routing, dispatch and combine on
each rank's local shards through ``local_map``
(``models/common.local_apply``); the xLSTM blocks, whose weights stay
replicated, run whole on each rank's rows of the batch (on each rank's
positions under a token split: below), and a codebook stack's embedding
and heads are vocab-parallel.

**A live pod axis.**  A ``("pod", "data", "model")`` mesh
(``mesh.make_device_mesh(..., n_pod=...)``) shards what the reference
shards over ``("pod", "data")`` over both, pod major: the batch, the
cohort's client axis and the caches' batch; the round's all-reduce runs
over the pod x data group (:meth:`MeshPolicy.data_group`).  Where the
reference names ``data`` alone (``seq2d_fsdp``'s ZeRO dim, kimi-k2's 2-D
experts) the port does too.

**Token splits** (``seq2d``, ``dp2d``, ``seq2d_fsdp``; every arch type).
The hidden state is a DTensor split over the sequence (``seq``) or the
batch (``dp2d``'s ``("data", "model")``), and each block runs whole on
each rank's tokens in one ``local_map`` (``models/transformer.
_split_block``, :class:`common.TokenSplit`): k and v gathered along the
sequence, K5 (prefill) or ``chunk2d_attention`` (training) on the rank's
query rows at their positions; the RG-LRU's conv halo and its scan's f32
carry from the ranks before (``models/rglru.py``); the mLSTM's conv halo
and its (C, n, m) state, and the sLSTM's (c, n, h, m) state, chained from
rank to rank (``models/xlstm.py``, ``common.split_chain``);
``seq2d_fsdp``'s data-sharded weights gathered at their use
(:meth:`MeshPolicy.gather_weights`).  Every redistribution of a token
split goes through ``common.redistribute_by_sum`` (all-reduces only,
forward and backward).  An MoE block routes each rank's part of a
sequence with the queue offsets of the ranks before it and the whole
sequence's capacity (``models/mlp.RoutingGroup``).  The serve step reads
the cache as :func:`cache_specs` places it, ``kv_seq`` rows, ``rnn``
channels and the xLSTM states' splits included, and never replicates a
sharded cache.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import MeshShape
from repro_torch.models.common import (Policy, TokenSplit, is_dtensor,
                                       redistribute_by_sum, shard_offset,
                                       sharding_dims)
from repro_torch.tree import (tree_leaves, tree_leaves_with_keys, tree_map,
                              tree_unflatten)

Tree = Any

TOKEN_SPLITS = ("seq2d", "dp2d", "seq2d_fsdp")


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None``, a mesh axis name, or a tuple of
    names.  A tuple, as JAX's ``PartitionSpec`` is, normalised as JAX's is
    (a one-name tuple is that name, an empty one ``None``), and a leaf of
    the port's trees (``tree_leaf``)."""

    tree_leaf = True

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else e[0] if len(e) == 1 else e
    return e


def _axis_size(mesh: MeshShape, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape.get(a, 1)
    return n


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class MeshPolicy(Policy):
    """Activation-constraint resolver for a (pod,) data, model mesh: a
    :class:`MeshShape` (spec math, dry-runs) or a live ``DeviceMesh``
    (``device_mesh``: the cohort-sharded round, and tensor parallelism
    where its model axis is larger than 1)."""

    def __init__(self, mesh, cfg: ModelConfig):
        self.device_mesh = None if isinstance(mesh, MeshShape) else mesh
        self.mesh = MeshShape.of(mesh)
        mesh = self.mesh
        self.cfg = cfg
        data = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
        self.data_axes = data
        # a live mesh with a model axis larger than 1: tensor parallelism
        self.model_live = self.device_mesh is not None and any(
            n > 1 for a, n in mesh.shape.items() if a not in data)
        heads_rule = "model"
        if cfg.attn_shard in ("replicate", "head_dim", "seq2d",
                              "seq2d_fsdp", "dp2d"):
            heads_rule = None
        self.seq2d = cfg.attn_shard in ("seq2d", "seq2d_fsdp")
        self.dp2d = cfg.attn_shard == "dp2d"
        # a live token split: the blocks run on each rank's tokens and
        # every redistribution is by all-reduces (module docstring); so is
        # a data-only live mesh's (the batch split, its gradients summed)
        self.token_split = self.model_live and cfg.attn_shard in TOKEN_SPLITS
        self.by_sum = self.token_split or (self.device_mesh is not None
                                           and not self.model_live)
        self.rules = {
            "batch": data + ("model",) if self.dp2d else data,
            "seq": "model" if self.seq2d else None,
            "seq_chunks": "model" if self.seq2d else None,
            "heads": heads_rule,
            "kv_heads": heads_rule,
            "head_dim": "model" if cfg.attn_shard == "head_dim" else None,
            "ffn": None if (self.seq2d or self.dp2d) else "model",
            "experts": "model",
            "expert_ffn": "model",
            "vocab": None if self.dp2d else "model",
            "rnn": "model",
            "mlstm_dh": None,
            "kv_seq": "model",
            # the cohort chunk's client axis over data/pod: the masked fold
            # of a chunk reduces it, which is the round's all-reduce
            "cohort": data,
        }
        # resolution priority when two logical names want the same mesh axis
        self.priority = {"kv_seq": 1, "seq": 1}  # vocab/heads first

    def spec(self, x_shape: Sequence[int],
             axes: Sequence[Optional[str]]) -> PartitionSpec:
        used = set()
        axes_t = tuple(axes)
        out: list = [None] * len(axes_t)
        order = sorted(range(len(out)),
                       key=lambda i: self.priority.get(axes_t[i], 0)
                       if axes_t[i] else 9)
        for i in order:
            name = axes_t[i]
            dim = x_shape[i]
            assign = self.rules.get(name) if name else None
            if assign is None:
                continue
            assign_t = (assign,) if isinstance(assign, str) else tuple(assign)
            # longest usable prefix: lets dp2d's ("data", "model") batch
            # rule fall back to plain data parallelism when batch < chips
            while assign_t:
                if (not any(a in used for a in assign_t)
                        and _axis_size(self.mesh, assign_t) > 1
                        and dim % _axis_size(self.mesh, assign_t) == 0):
                    out[i] = (assign_t if len(assign_t) > 1
                              else assign_t[0])
                    used.update(assign_t)
                    break
                assign_t = assign_t[:-1]
        return P(*out)

    def constrain(self, x: torch.Tensor, axes: Sequence[Optional[str]]):
        """``redistribute`` of a DTensor to the resolved spec; the identity
        on ``meta`` and on a plain tensor sharded only over data axes or
        axes of size 1; ``TypeError`` on a plain tensor with values whose
        spec shards over a model axis larger than 1 (module docstring)."""
        if is_dtensor(x):
            return self.place(x, self.spec(x.shape, axes))
        if x.is_meta:
            return x
        for entry in self.spec(x.shape, axes):
            for a in _names(entry):
                if a not in self.data_axes and self.mesh.shape.get(a, 1) > 1:
                    raise TypeError(
                        f"a plain tensor {tuple(x.shape)} where {tuple(axes)}"
                        f" resolves to {self.spec(x.shape, axes)} on "
                        f"{self.mesh}: a model-sharded activation must be a "
                        f"DTensor (distribute_params)")
        return x

    def place(self, x, spec: PartitionSpec):
        """DTensor ``x`` placed by ``spec``: DTensor's ``redistribute``, or
        under a live token split or over a data-only live mesh
        ``common.redistribute_by_sum`` (all-reduces only, forward and
        backward)."""
        placements = to_placements(spec, self.mesh)
        if self.by_sum:
            return redistribute_by_sum(x, placements)
        return x.redistribute(x.device_mesh, placements)

    def gather_weights(self, tree: Tree) -> Tree:
        """``tree``'s DTensor leaves gathered over the data axes where
        ``seq2d_fsdp`` shards them (ZeRO-3, at their use: one all-reduce a
        leaf, whose backward sums the gradient over data and keeps this
        rank's slice, as a reduce-scatter would); the tree as it is
        otherwise."""
        if not (self.token_split and self.cfg.attn_shard == "seq2d_fsdp"):
            return tree
        from torch.distributed.tensor import Replicate
        names = self.mesh.axis_names

        def gather(x):
            if not is_dtensor(x):
                return x
            return redistribute_by_sum(x, [
                Replicate() if pl.is_shard() and names[i] in self.data_axes
                else pl for i, pl in enumerate(x.placements)])
        return tree_map(gather, tree)

    def local_split(self, h) -> TokenSplit:
        """The :class:`common.TokenSplit` of the hidden state ``h`` (B, S,
        D), a DTensor: the mesh dims that split its sequence and this
        rank's first position, and those that split its batch."""
        return TokenSplit(h.device_mesh, sharding_dims(h, 1),
                          shard_offset(h, 1), h.shape[1], self.seq2d,
                          sharding_dims(h, 0), h.shape[0])

    def model_policy(self) -> "MeshPolicy":
        """The policy of this rank's model group alone (the live mesh's
        ``model`` sub-mesh, no data axis): what one client's training runs
        under in the round step, since each data rank trains its own
        clients."""
        return MeshPolicy(self.device_mesh["model"], self.cfg)

    # -- the live mesh's data group (the cohort-sharded round) ------------

    def data_group(self):
        """The process group of the ranks that share this rank's model
        coordinate across the data axes (``pod`` x ``data``: the round's
        all-reduce).  Over a pod axis every rank creates every such group,
        in one order (``dist.new_group`` is collective), once a mesh."""
        if self.data_axes == ("data",):
            return self.device_mesh.get_group("data")
        return _data_groups(self.device_mesh)

    def data_coordinate(self) -> Tuple[int, int]:
        """``(this rank's index along the data axes, their size)``: pod
        major, as JAX flattens ``("pod", "data")``."""
        index, size = 0, 1
        for a in self.data_axes:
            index = index * self.mesh.shape[a] + \
                self.device_mesh.get_local_rank(a)
            size *= self.mesh.shape[a]
        return index, size

    def data_rows(self, n: int) -> Tuple[int, int]:
        """Rows ``[start, stop)`` of an ``n``-row client axis that this
        rank holds where the data axes shard it: ``Shard(0)`` on each, in
        mesh order, which DTensor nests (pod's share first, then data's
        share of it), as :func:`distribute_cohort` places a cohort.  Over
        a pod axis an uneven ``n`` is not split as its flattened
        coordinate would split it: 6 rows over (2, 2) are 2, 1, 2, 1."""
        start, stop = 0, n
        for a in self.data_axes:
            lo, hi = shard_rows(stop - start,
                                self.device_mesh.get_local_rank(a),
                                self.mesh.shape[a])
            start, stop = start + lo, start + hi
        return start, stop


def _data_groups(device_mesh):
    """This rank's group of the ranks of ``device_mesh`` (named "pod",
    "data", "model") that share its model coordinate, pod-major; every
    rank creates every model coordinate's group, in order, at the first
    call on a mesh, and the mesh keeps them."""
    groups = getattr(device_mesh, "_pod_data_groups", None)
    if groups is None:
        import torch.distributed as dist
        ranks = device_mesh.mesh
        names = device_mesh.mesh_dim_names
        ranks = ranks.permute(names.index("model"), names.index("pod"),
                              names.index("data")).flatten(1)
        groups = {}
        for row in ranks.tolist():
            group = dist.new_group(row)
            for r in row:
                groups[r] = group
        device_mesh._pod_data_groups = groups
    return groups[device_mesh.get_rank()]


def shard_rows(n: int, index: int, parts: int) -> Tuple[int, int]:
    """Rows ``[start, stop)`` of an ``n``-row dim that part ``index`` of
    ``parts`` holds under DTensor's ``Shard``: ``torch.chunk``'s split,
    ``ceil(n / parts)`` rows a part, the last parts shorter or empty."""
    size = -(-n // parts) if parts else n
    start = min(index * size, n)
    return start, min(start + size, n)


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def _div(mesh: MeshShape, dim: int, axis) -> bool:
    return dim % _axis_size(mesh, axis) == 0


def _leaf_param_spec(keys: Tuple[str, ...], shape: Tuple[int, ...],
                     cfg: ModelConfig, mesh: MeshShape,
                     stacked: bool) -> PartitionSpec:
    """Spec for one parameter leaf; ``stacked`` means a leading period
    axis."""
    body = shape[1:] if stacked else shape
    name = keys[-1]
    parent = keys[-2] if len(keys) > 1 else ""
    spec: Tuple = (None,) * len(body)
    m = "model"

    def ok(i, axis=m):
        return _div(mesh, body[i], axis)

    in_mixer = "mixer" in keys
    in_experts = "experts" in keys
    in_embed = "embed" in keys

    # SSM (xLSTM) mixers stay replicated at baseline
    if in_mixer and cfg.arch_type == "ssm":
        return P(*((None,) + spec if stacked else spec))

    # seq2d/dp2d: weights replicate, tokens shard 2D; seq2d keeps the
    # embedding vocab-sharded, dp2d replicates it too
    if cfg.attn_shard == "seq2d" and not in_embed:
        return P(*((None,) + spec if stacked else spec))
    if cfg.attn_shard == "dp2d":
        return P(*((None,) + spec if stacked else spec))
    # seq2d_fsdp: tokens shard 2D like seq2d, weights over `data`
    if cfg.attn_shard == "seq2d_fsdp" and not in_embed:
        fs = [None] * len(body)
        for i, dim in enumerate(body):
            if _div(mesh, dim, "data") and dim >= 64:
                fs[i] = "data"
                break
        fs = tuple(fs)
        return P(*((None,) + fs if stacked else fs))

    if in_embed and name in ("table",):
        if ok(0):
            spec = (m, None)
    elif in_embed and name == "tables":
        if ok(1):
            spec = (None, m, None)
    elif name == "w" and parent == "unembed":
        if ok(1):
            spec = (None, m)
    elif in_experts and name in ("gate", "up"):        # (E, D, F)
        if cfg.shard_experts_2d and ok(0) and _div(mesh, body[2], "data"):
            spec = (m, None, "data")
        elif ok(0):
            spec = (m, None, None)
        elif ok(2):
            spec = (None, None, m)
    elif in_experts and name == "down":                # (E, F, D)
        if cfg.shard_experts_2d and ok(0) and _div(mesh, body[1], "data"):
            spec = (m, "data", None)
        elif ok(0):
            spec = (m, None, None)
        elif ok(1):
            spec = (None, m, None)
    elif name == "router":
        spec = (None, None)
    elif in_mixer and name == "wq":                    # (D, H, Dh)
        if cfg.attn_shard == "head_dim" and ok(2):
            spec = (None, None, m)
        elif ok(1) and cfg.attn_shard != "replicate":
            spec = (None, m, None)
    elif in_mixer and name in ("wk", "wv"):            # (D, Kh, Dh)
        if cfg.attn_shard == "head_dim" and ok(2):
            spec = (None, None, m)
        elif ok(1) and cfg.attn_shard not in ("replicate",):
            spec = (None, m, None)
    elif in_mixer and name == "wo":                    # (H, Dh, D)
        if cfg.attn_shard == "head_dim" and ok(1):
            spec = (None, m, None)
        elif ok(0) and cfg.attn_shard != "replicate":
            spec = (m, None, None)
    elif in_mixer and name in ("w_in", "w_gate", "w_up"):   # (D, Dr/Di)
        if ok(1):
            spec = (None, m)
    elif in_mixer and name in ("w_out", "w_down"):     # (Dr/Di, D)
        if ok(0):
            spec = (m, None)
    elif in_mixer and name == "conv":                  # (tw, Dr/Di)
        if ok(1):
            spec = (None, m)
    elif in_mixer and name in ("w_r", "b_r", "w_i", "b_i", "lam"):  # (Dr,)
        if ok(0):
            spec = (m,)
    elif in_mixer and name in ("wq", "wk", "wv") and len(body) == 3:
        pass  # handled above (attention); mlstm variant below
    elif in_mixer and len(body) == 3 and name in ("r",):
        spec = (None, None, None, None)[:len(body)]
    elif "mlp" in keys or "shared" in keys:
        if name in ("gate", "up") and ok(1):           # (D, F)
            spec = (None, m)
        elif name == "down" and ok(0):                 # (F, D)
            spec = (m, None)
    elif name == "w" and parent == "frontend_proj":
        spec = (None, None)

    # mLSTM block-diagonal qkv: (NH, DH, DH) -> shard output DH
    if in_mixer and name in ("wq", "wk", "wv") and len(body) == 3 \
            and body[0] == cfg.n_heads and body[1] == body[2]:
        spec = (None, None, m) if _div(mesh, body[2], m) else (None,) * 3

    if stacked:
        spec = (None,) + tuple(spec)
    return P(*spec)


def _specs_like(tree: Tree, leaf_spec) -> Tree:
    specs = [leaf_spec(keys, tuple(leaf.shape), "periods" in keys)
             for keys, leaf in tree_leaves_with_keys(tree)]
    return tree_unflatten(tree_map(lambda _: None, tree), specs)


def param_specs(params: Tree, cfg: ModelConfig, mesh) -> Tree:
    """PartitionSpec tree matching ``params`` (works on ``meta``
    tensors)."""
    mesh = MeshShape.of(mesh)
    return _specs_like(params, lambda keys, shape, stacked: _leaf_param_spec(
        keys, shape, cfg, mesh, stacked))


def cohort_specs(params: Tree, cfg: ModelConfig, mesh) -> Tree:
    """PartitionSpec tree for a *stacked cohort* of client models: the
    leading client axis over ``data``/``pod``, each client's parameters
    keeping their :func:`param_specs` layout within.  (The reference
    returns ``NamedSharding``s of these specs; :func:`to_placements` is
    the port's counterpart of that step.)"""
    data = tuple(a for a in ("pod", "data")
                 if a in MeshShape.of(mesh).axis_names)
    return tree_map(lambda s: P(data, *tuple(s)),
                    param_specs(params, cfg, mesh))


# ---------------------------------------------------------------------------
# Cache specs (decode)
# ---------------------------------------------------------------------------

def _leaf_cache_spec(keys: Tuple[str, ...], shape: Tuple[int, ...],
                     cfg: ModelConfig, mesh: MeshShape, stacked: bool,
                     data_axes) -> PartitionSpec:
    body = shape[1:] if stacked else shape
    name = keys[-1]
    m = "model"
    batch = body[0]
    batch_ok = _div(mesh, batch, data_axes)
    spec = [data_axes if batch_ok else None] + [None] * (len(body) - 1)

    if name in ("k", "v") and len(body) == 4:          # (B, S, Kh, Dh)
        if not batch_ok and _div(mesh, body[1], data_axes):
            spec[1] = data_axes                        # context-parallel cache
        if cfg.attn_shard == "head_dim" and _div(mesh, body[3], m):
            spec[3] = m
        elif _div(mesh, body[2], m) and cfg.attn_shard != "replicate":
            spec[2] = m
        elif spec[1] is None and _div(mesh, body[1], m):
            spec[1] = m                                # kv-seq over model
    elif name == "C" and len(body) == 4:               # (B, NH, DH, DH)
        if _div(mesh, body[2], m):
            spec[2] = m                                # value index
    elif name in ("y",) and len(body) == 2:            # rglru (B, Dr)
        if _div(mesh, body[1], m):
            spec[1] = m
    elif name == "conv" and len(body) == 3:            # (B, tw-1, Dr/Di)
        if _div(mesh, body[2], m):
            spec[2] = m
    elif name == "n" and len(body) == 3:               # mlstm (B, NH, DH)
        if _div(mesh, body[2], m):
            spec[2] = m

    if stacked:
        spec = [None] + spec
    return P(*spec)


def cache_specs(cache: Tree, cfg: ModelConfig, mesh) -> Tree:
    mesh = MeshShape.of(mesh)
    data = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return _specs_like(cache, lambda keys, shape, stacked: _leaf_cache_spec(
        keys, shape, cfg, mesh, stacked, data))


# ---------------------------------------------------------------------------
# Input (batch) specs
# ---------------------------------------------------------------------------

def batch_specs(batch: Tree, mesh, policy=None) -> Tree:
    mesh = MeshShape.of(mesh)
    data = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    if policy is not None and getattr(policy, "dp2d", False):
        data = data + ("model",)

    def leaf(x):
        if x.dim() == 0:
            return P()
        if _div(mesh, x.shape[0], data):
            return P(data, *([None] * (x.dim() - 1)))
        return P(*([None] * x.dim()))

    return tree_map(leaf, batch)


def to_placements(spec: PartitionSpec, mesh) -> list:
    """DTensor placements of ``spec`` over ``mesh``'s dims, in order:
    ``Shard(d)`` where tensor dim ``d`` names the mesh dim, else
    ``Replicate()``.  A mesh axis named by two tensor dims raises
    ``ValueError``, as JAX's ``NamedSharding`` refuses such a spec."""
    from torch.distributed.tensor import Replicate, Shard
    names = MeshShape.of(mesh).axis_names
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        for a in _names(entry):
            if isinstance(out[names.index(a)], Shard):
                raise ValueError(f"{spec} maps mesh axis {a!r} to two "
                                 f"dims")
            out[names.index(a)] = Shard(d)
    return out


def bytes_per_chip(tree: Tree, specs: Tree, mesh) -> int:
    """Per-device bytes of a sharded tree (ceil for uneven shards)."""
    mesh = MeshShape.of(mesh)
    total = 0
    for leaf, spec in zip(tree_leaves(tree), tree_leaves(specs)):
        per = leaf.element_size()
        for dim, axes in zip(leaf.shape, tuple(spec) + (None,) * leaf.dim()):
            per *= math.ceil(dim / _axis_size(mesh, axes))
        total += per
    return total


# ---------------------------------------------------------------------------
# DTensor trees over a live mesh
# ---------------------------------------------------------------------------

def distribute_leaf(x: torch.Tensor, device_mesh, placements):
    """``x`` (the same full tensor on every rank) as a DTensor: each rank
    keeps its own shard, with no collective (``src_data_rank=None``).
    A leaf whose leading axis is an ``expand``-ed view (a cohort in which
    every client aliases one model) keeps that view: its first row is
    distributed and the local shard expanded to this rank's rows of the
    leading axis."""
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    if not (x.dim() and x.shape[0] > 1 and x.stride(0) == 0):
        return distribute_tensor(x, device_mesh, placements,
                                 src_data_rank=None)
    rows = x.shape[0]
    row = []
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == 0:
            lo, hi = shard_rows(rows, device_mesh.get_local_rank(i),
                                device_mesh.size(i))
            rows = hi - lo
            row.append(Replicate())
        else:
            row.append(Shard(p.dim - 1) if isinstance(p, Shard) else p)
    local = distribute_tensor(x[0], device_mesh, row,
                              src_data_rank=None).to_local()
    return DTensor.from_local(
        local[None].expand((rows,) + tuple(local.shape)), device_mesh,
        placements, run_check=False, shape=x.shape,
        stride=torch.empty(x.shape, device="meta").stride())


def _distribute(tree: Tree, specs: Tree, device_mesh) -> Tree:
    """Replace each leaf of ``tree`` by its DTensor, in place in its dict
    (every leaf of a parameter or cohort tree sits in a dict), so each full
    leaf is freed as its shard replaces it; returns ``tree``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            if isinstance(tree[k], torch.Tensor):
                tree[k] = distribute_leaf(
                    tree[k], device_mesh, to_placements(specs[k],
                                                        device_mesh))
            else:
                _distribute(tree[k], specs[k], device_mesh)
    elif isinstance(tree, (tuple, list)):
        for t, s in zip(tree, specs):
            _distribute(t, s, device_mesh)
    else:
        raise TypeError(f"a parameter leaf outside a dict: {type(tree)}")
    return tree


def distribute_params(params: Tree, cfg: ModelConfig, device_mesh) -> Tree:
    """``params`` (the same full tree on every rank) as DTensors over the
    live ``device_mesh``, each leaf placed by :func:`param_specs`.  **In
    place**: each full leaf is replaced in its dict by its shard, one leaf
    at a time, so the peak is the sharded tree plus one full leaf (pass a
    copy of the dicts, ``tree_map(lambda x: x, params)``, to keep the full
    tree).  Returns the tree."""
    return _distribute(params, param_specs(params, cfg, device_mesh),
                       device_mesh)


def distribute_cohort(cohort: Tree, cfg: ModelConfig, device_mesh) -> Tree:
    """A stacked cohort (leaves ``(K, ...)``, the same on every rank) as
    DTensors placed by :func:`cohort_specs`, in place as
    :func:`distribute_params`: the client axis over the data ranks, each
    client's parameters as :func:`param_specs` lays them out.  An
    ``expand``-ed cohort stays a view (:func:`distribute_leaf`)."""
    specs = cohort_specs(tree_map(lambda x: x[0], cohort), cfg, device_mesh)
    return _distribute(cohort, specs, device_mesh)


def distribute_cache(cache: Tree, cfg: ModelConfig, device_mesh) -> Tree:
    """A decode cache (the same full tree on every rank, e.g.
    ``transformer.init_cache``) as DTensors placed by :func:`cache_specs`,
    in place as :func:`distribute_params`: what ``make_prefill_step``
    hands back over a live mesh."""
    return _distribute(cache, cache_specs(cache, cfg, device_mesh),
                       device_mesh)


def local_tree(tree: Tree) -> Tree:
    """Each DTensor leaf's local shard (``to_local``); other leaves as
    they are.  A leaf with a ``Partial`` placement raises ``ValueError``:
    its local tensor is one rank's term of a sum, not its shard."""
    def local(x):
        if not is_dtensor(x):
            return x
        if any(p.is_partial() for p in x.placements):
            raise ValueError(f"a Partial DTensor {tuple(x.shape)} "
                             f"{x.placements} has no local shard")
        return x.to_local()
    return tree_map(local, tree)


def check_groups(tree: Tree, quant_block: int) -> None:
    """Raise ``ValueError``, naming the leaf, unless each sharded DTensor
    leaf of ``tree`` (one client's parameters) holds whole
    ``quant_block``-element groups of the global flat layout on every
    rank.  The int8 wire quantizes the flat update in groups, and every
    leaf starts lane-aligned (``flatten.LANES``), so a leaf sharded on dim
    ``d`` is held as runs of ``prod(local.shape[d:])`` elements, each
    starting a multiple of that length into a global row: when that
    length is a multiple of ``quant_block``, the local flat layout's
    groups are exactly global groups, and each rank's scales are the
    unsharded wire's."""
    for keys, x in tree_leaves_with_keys(tree):
        if not is_dtensor(x):
            continue
        local = x.to_local().shape
        for pl in x.placements:
            if pl.is_shard() and math.prod(local[pl.dim:]) % quant_block:
                raise ValueError(
                    f"int8 wire over a model axis: leaf {'/'.join(keys)} "
                    f"{tuple(x.shape)} sharded on dim {pl.dim} holds runs "
                    f"of {math.prod(local[pl.dim:])} elements a rank, not "
                    f"whole groups of {quant_block}: its local groups "
                    f"would straddle the global ones")
