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
``dp2d`` / ``seq2d_fsdp``.  ``shard_experts_2d`` (kimi-k2): expert
weights sharded over model AND data.  The spec arithmetic is the
reference's, line for line, so the port's specs equal its specs on every
config of the zoo at both production mesh shapes.

Two pieces replace the reference's JAX-only ones:

* :func:`to_placements` (for ``to_named``) turns a spec into DTensor
  placements over a mesh: ``Shard(d)`` on each mesh dim that tensor dim
  ``d`` names, ``Replicate()`` on the others.  A dim named by ("pod",
  "data") is ``Shard(d)`` on both, pod major, as JAX splits it.
* :meth:`MeshPolicy.constrain` executes only what a data-parallel mesh
  needs: it is the identity on a tensor whose resolved spec shards over
  data or pod axes or axes of size 1 (each rank already holds its share;
  the cohort-sharded round in ``launch/steps.py`` takes each rank's
  clients), and on ``meta`` tensors (the dry-runs).  A live mesh with a
  model axis larger than 1 raises ``NotImplementedError``: tensor
  parallelism is not ported (ROADMAP.md §1), and a policy that silently
  replicated would report one chip's numbers under a mesh's name.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import MeshShape
from repro_torch.models.common import Policy
from repro_torch.tree import (tree_leaves, tree_leaves_with_keys, tree_map,
                              tree_unflatten)

Tree = Any

MODEL_AXIS_TODO = ("execution over a live model axis larger than 1 (tensor "
                   "parallelism) is not ported: ROADMAP.md §1, 'Execution "
                   "over a live model axis'")


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
    (``device_mesh``; the cohort-sharded round)."""

    def __init__(self, mesh, cfg: ModelConfig):
        self.device_mesh = None if isinstance(mesh, MeshShape) else mesh
        self.mesh = MeshShape.of(mesh)
        mesh = self.mesh
        self.cfg = cfg
        data = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
        self.data_axes = data
        if self.device_mesh is not None and any(
                n > 1 for a, n in mesh.shape.items() if a not in data):
            raise NotImplementedError(f"{MODEL_AXIS_TODO}; mesh {mesh}")
        heads_rule = "model"
        if cfg.attn_shard in ("replicate", "head_dim", "seq2d",
                              "seq2d_fsdp", "dp2d"):
            heads_rule = None
        self.seq2d = cfg.attn_shard in ("seq2d", "seq2d_fsdp")
        self.dp2d = cfg.attn_shard == "dp2d"
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
        """The identity, where it is one (module docstring); raises
        ``NotImplementedError`` on a tensor with values whose spec shards
        over a model axis larger than 1."""
        if x.is_meta:
            return x
        for entry in self.spec(x.shape, axes):
            for a in _names(entry):
                if a not in self.data_axes and self.mesh.shape.get(a, 1) > 1:
                    raise NotImplementedError(
                        f"{MODEL_AXIS_TODO}; {tuple(axes)} resolves to "
                        f"{self.spec(x.shape, axes)} on {self.mesh}")
        return x

    # -- the live mesh's data group (the cohort-sharded round) ------------

    def data_group(self):
        """The process group of this rank's data axis (the round's
        all-reduce)."""
        if "pod" in self.mesh.axis_names:
            raise NotImplementedError("a live mesh with a pod axis")
        return self.device_mesh.get_group("data")

    def data_coordinate(self) -> Tuple[int, int]:
        """``(this rank's index along data, the data axis's size)``."""
        return (self.device_mesh.get_local_rank("data"),
                self.mesh.shape["data"])


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
