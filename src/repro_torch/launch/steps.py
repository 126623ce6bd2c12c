"""Launch-side step functions: the port of ``repro.launch.steps``.

* ``make_train_step`` — one complex-device step: the side objective (final
  CE + early-exit CE) or the plain objective, one clipped SGD step.
* ``make_fed_round_step`` — one complete FedHeN round over a stacked
  cohort, streamed in ``cohort_chunk``-sized chunks through an
  :func:`repro_torch.core.aggregate.make_engine` fold.
* ``make_prefill_step`` — logits and decode cache for a prompt batch.
* ``make_serve_step`` — one token against a cache (decode shapes).
* ``step_for_shape`` — the step an ``InputShape`` exercises.

Each factory takes the reference's sharding ``policy`` (default
``NO_POLICY``: today's step, call for call) and hands it to the adapter or
the model.  A step runs on the device of the tensors it is given.

**The cohort-sharded round.**  Given a ``sharding.MeshPolicy`` over a live
``DeviceMesh`` (``mesh.make_device_mesh``), ``make_fed_round_step`` splits
each chunk's client axis over the data ranks as DTensor's ``Shard(0)``
splits it (contiguous; uneven, or empty, where the chunk does not divide;
over a pod axis nested, pod's share first, ``MeshPolicy.data_rows``):
each rank reads its clients' rows of the cohort, ``data``, ``is_simple``,
``staleness`` and ``real``, trains them and folds them into its own engine
state.  After the last chunk one ``all_reduce(SUM)`` over the data group
(``aggregate.allreduce_state``; over pod x data with a pod axis) sums the
states and the loss sum, and every
rank finalizes the same new model.  This is the reference's communication
pattern: its ``cohort`` rule shards the chunk over data, and the fold's
reduction of that axis is the round's all-reduce.  On one rank it is
bitwise the unsharded step (the same launches fold the same rows in the
same order, and a one-rank sum is the identity).

**A live model axis (tensor parallelism).**  Under a ``MeshPolicy`` whose
live mesh has a model axis larger than 1 the steps take DTensors
(``sharding.distribute_params``; the round a cohort from
``sharding.distribute_cohort``) and return DTensors, computing what GSPMD
computes for the reference under the same policy.  The train and prefill
steps run the model on DTensors (``implicit_replication``: a plain tensor
such as a mask or the tokens counts as replicated); prefill's cache is
constrained to ``sharding.cache_specs``, and the serve step decodes
against that cache on each rank's shards (``models/attention.py``: heads,
head dim, or ``kv_seq`` rows merged by all-reduces; ``models/rglru.py``:
the ``rnn`` channels).  An MoE config's experts run on each rank's experts
or ``expert_ffn`` shard (``models/mlp.py``); the router's gradient
arrives ``Partial`` over model and, like every gradient, is redistributed
to its parameter's placements.  In the round step each data rank
trains its rows of each chunk as above, each client as DTensors over its
model group (``MeshPolicy.model_policy``); a client is valid only where
every shard is finite (``masking.tree_isfinite``); the fold runs on each
rank's local shards (``flatten.layout_of`` over the local shapes, K1/K2 or
K4 on the local flat vector, no model-axis collective: the fold is
elementwise), and the new model's local leaves are wrapped back as
DTensors.  On the int8 wire each sharded leaf's local rows must be whole
groups of the global layout (``sharding.check_groups``), so that each
rank quantizes exactly the reference's groups.

**Compressed-wire and SCAFFOLD specs** run as the reference's round step
runs them, on one device or over a mesh: it hands its fold no sparse chunk
and no control-variate chunk, so a delta-mode spec (top-k, stochastic,
error feedback) folds the dense uploads at its payload dtype (an int8 spec
through the dequantizing K2, an f32 one as the f32 wire: bitwise the spec
without its delta options), and a SCAFFOLD spec folds what the spec
without it folds; its zero control-variate accumulator is not allocated.

**Token splits** (``attn_shard`` ``seq2d`` / ``dp2d`` / ``seq2d_fsdp``,
the dense, VLM, hybrid and audio configs): the model runs its blocks on
each rank's tokens (``models/transformer.py``; the RG-LRU with its conv
halo and f32 carry, ``models/rglru.py``), the train, prefill and serve
steps as
above, and the round step under ``seq2d`` and ``dp2d`` with each client
under ``MeshPolicy.model_policy``.  A ``seq2d_fsdp`` cohort's specs name
``data`` twice (the client axis and the weights' ZeRO-3 dim), so placing
one raises ``ValueError`` as the reference's ``NamedSharding`` refuses
it.  Prefill hands the cache back placed by ``sharding.cache_specs``,
reached from the sequence- or batch-split k/v by all-reduces.

Where the reference ``vmap``s a chunk's clients and ``scan``s the chunks,
the round step loops over both in Python, training one client at a time;
the fold is one engine call a chunk, as in the reference.  Three of the
reference's behaviours are kept on purpose:

* **The batch a local step sees.**  The reference hands each client its
  data transposed to ``(local_steps, B, S+1)`` and trains step ``i`` on
  ``data[:, i]``: the ``local_steps`` rows at batch index ``i`` of the
  client's ``(B, local_steps, S+1)`` block.  JAX clamps a static index out
  of range, so with ``B < local_steps`` step ``i >= B`` reuses row
  ``B - 1``; the port indexes ``min(i, B - 1)``.
* **The loss it reports** is ``loss_side`` of each client's last local
  step, simple clients included, although a simple client takes the
  gradient of ``loss_simple``; the port evaluates that side loss without a
  backward pass through it.
* **The cohort is never written.**  It may be an ``expand``-ed view in
  which every client aliases one model (the counterpart of the reference
  tests' ``broadcast_to``); each client is cloned before its SGD.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Dict, Optional

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core import aggregate, async_rounds, comm, flatten, masking
from repro_torch.core.adapters import LMAdapter
from repro_torch.launch import sharding
from repro_torch.models import transformer as tfm
from repro_torch.models import common
from repro_torch.models.common import NO_POLICY, Policy
from repro_torch.obs import telemetry as obslib
from repro_torch.optim.sgd import sgd_update
from repro_torch.tree import Tree, tree_flatten, tree_map, tree_unflatten

Batch = Dict[str, torch.Tensor]


def _value_and_grad(loss_fn, params: Tree, batch: Batch):
    """``(loss, grads)`` of ``loss_fn`` at ``params``; a leaf the loss does
    not touch gets a ``None`` gradient, which SGD reads as zero.  A DTensor
    gradient is redistributed to its parameter's placements (a ``Partial``
    gradient of a replicated parameter is all-reduced), as GSPMD lays the
    gradients out like the parameters."""
    leaves, treedef = tree_flatten(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = loss_fn(params, batch)
    grads = list(torch.autograd.grad(loss, leaves, allow_unused=True))
    for i, leaf in enumerate(leaves):
        leaf.requires_grad_(False)
        if grads[i] is not None and sharding.is_dtensor(grads[i]) and \
                grads[i].placements != leaf.placements:
            grads[i] = grads[i].redistribute(leaf.device_mesh,
                                             leaf.placements)
    return loss.detach(), tree_unflatten(treedef, grads)


def _sgd(params: Tree, grads: Tree, lr: float, clip_norm: float) -> Tree:
    with torch.no_grad():
        return sgd_update(params, grads, lr, clip_norm)


def _model_live(policy: Policy) -> bool:
    return getattr(policy, "model_live", False)


def _tp(policy: Policy):
    """The context a step runs its model in: DTensor's
    ``implicit_replication`` over a live mesh (the parameters DTensors
    over a model axis, or over a data-only mesh such as (2, 1), where
    kimi-k2's 2-D experts are sharded over data), else nothing."""
    if getattr(policy, "device_mesh", None) is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _value(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's value as a plain tensor (``full_tensor``: no collective
    for a replicated one, an all-reduce for a ``Partial`` sum such as a
    loss over a data-sharded batch)."""
    return x.full_tensor() if sharding.is_dtensor(x) else x


def _contiguous_stride(shape) -> tuple:
    return torch.empty(shape, device="meta").stride()


class _ModelAxisCohort:
    """A cohort of DTensors (``sharding.distribute_cohort``) as the round
    step reads it over a live model axis: each client's parameters as
    DTensors over the model group, the local template the fold lays out,
    and the new model wrapped back over the whole mesh."""

    def __init__(self, cohort: Tree, policy):
        from torch.distributed.tensor import Replicate, Shard
        leaves = tree_flatten(cohort)[0]
        if not all(sharding.is_dtensor(x) for x in leaves):
            raise TypeError("over a live model axis the round step takes a "
                            "DTensor cohort (sharding.distribute_cohort)")
        self.local = sharding.local_tree(cohort)
        self.mesh = policy.device_mesh
        self.model_mesh = self.mesh["model"]
        dm = self.mesh.mesh_dim_names.index("model")
        # the clients this rank holds: its Shard(0) rows over the data
        # axes, nested in mesh order as DTensor places them
        self.lo, self.hi = common.held_rows(
            leaves[0].shape[0], self.mesh, common.sharding_dims(leaves[0], 0))

        def model_place(pl):
            return Shard(pl.dim - 1) if isinstance(pl, Shard) else Replicate()

        self.client_place = tree_map(
            lambda x: [model_place(x.placements[dm])], cohort)
        self.param_place = tree_map(lambda x: [
            model_place(pl) if i == dm else Replicate()
            for i, pl in enumerate(x.placements)], cohort)
        self.shapes = tree_map(lambda x: tuple(x.shape[1:]), cohort)
        self.template = tree_map(lambda x: x[0], self.local)

    def client(self, z: int) -> Tree:
        """Client ``z``'s parameters as DTensors over the model group."""
        if not self.lo <= z < self.hi:
            raise ValueError(
                f"client {z} is not among this rank's rows [{self.lo}, "
                f"{self.hi}) of a cohort sharded over data: fold it in one "
                f"chunk (cohort_chunk=0)")
        return tree_map(lambda x, pl, shape: _from_local(
            x[z - self.lo], self.model_mesh, pl, shape), self.local,
            self.client_place, self.shapes)

    def template_dtensors(self) -> Tree:
        """One client's local template as DTensors over the model group."""
        return tree_map(lambda x, pl, shape: _from_local(
            x, self.model_mesh, pl, shape), self.template,
            self.client_place, self.shapes)

    def wrap(self, local: Tree) -> Tree:
        """The new model's local leaves as DTensors over the whole mesh."""
        return tree_map(lambda x, pl, shape: _from_local(
            x, self.mesh, pl, shape), local, self.param_place, self.shapes)


def _from_local(x, mesh, placements, shape):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(x, mesh, placements, run_check=False,
                              shape=shape, stride=_contiguous_stride(shape))


def make_train_step(cfg: ModelConfig, policy: Policy = NO_POLICY, *,
                    lr: float = 0.1, clip_norm: float = 10.0,
                    side_objective: bool = True, remat: bool = True):
    """``train_step(params, batch) -> (new_params, {"loss": loss})``; the
    input params are not modified (they are detached first)."""
    adapter = LMAdapter(cfg, policy=policy, remat=remat)
    loss_fn = adapter.loss_side if side_objective else adapter.loss_complex

    def train_step(params: Tree, batch: Batch):
        with _tp(policy):
            p = tree_map(lambda x: x.detach(), params)
            loss, grads = _value_and_grad(loss_fn, p, batch)
            return (_sgd(p, grads, lr, clip_norm),
                    {"loss": _value(loss)})

    return train_step


def make_fed_round_step(cfg: ModelConfig, policy: Policy = NO_POLICY, *,
                        local_steps: int, lr: float = 0.1,
                        clip_norm: float = 10.0,
                        cohort_chunk: int = 0,
                        engine: Optional[aggregate.EngineSpec] = None,
                        staleness_scheme: str = "poly",
                        staleness_decay: float = 0.5,
                        telemetry: Optional[obslib.Telemetry] = None,
                        agg_engine: Optional[str] = None,
                        agg_block_n: Optional[int] = None,
                        comm_dtype: Optional[str] = None,
                        quant_block: Optional[int] = None):
    """One FedHeN round over a stacked cohort, streamed in chunks.

    Returns ``round_step(cohort, data, is_simple, flat_mask=None,
    staleness=None, real=None) -> (new_complex, loss)``: ``cohort`` stacked
    client params (leaves ``(K, ...)``), ``data`` ``(K, B, local_steps,
    S+1)`` tokens, ``is_simple`` ``(K,)`` bool.  ``cohort_chunk`` must
    divide K (0 = one chunk).  Each chunk's clients train (side objective
    for complex clients, the subnet objective for simple ones), and the
    chunk folds at weights ``valid * staleness_weight(staleness) * real``,
    ``valid`` each client's finiteness (a NaN client folds at weight 0).

    ``engine`` is an :class:`~repro_torch.core.aggregate.EngineSpec`
    without ``mask`` / ``layout`` / ``flat_mask``: those are bound per call
    from the cohort's template.  ``None`` means the flat engine on the f32
    wire (``WireSpec("float32", 128)``), and a spec without a wire gets
    that wire.  The legacy kwargs ``agg_engine`` / ``agg_block_n`` /
    ``comm_dtype`` / ``quant_block`` warn and build the same spec; passing
    both forms raises ``ValueError``.

    ``flat_mask``: the precomputed flat bitvector (``flatten.pack_mask``
    over ``flatten.layout_of`` of one client at ``block_n``); ``None``
    packs it per call.  ``staleness``:
    ``(K,)`` broadcast staleness in rounds (the async engine's seam);
    ``None`` and all zeros are the synchronous fold.  ``real``: ``(K,)``
    bool, ``False`` for a super-cohort pad slot, which folds at weight 0
    and is left out of the loss mean (whose denominator is then
    ``max(sum(real), 1)``).

    ``telemetry`` records one ``round_step_build`` ledger with the step's
    static configuration and :func:`aggregate.engine_attrs` of its spec.

    ``policy``: a ``MeshPolicy`` over a live mesh shards each chunk's
    clients over its data ranks and all-reduces the fold, and one whose
    model axis is larger than 1 also shards each client's parameters over
    the model ranks (module docstring; the cohort a DTensor tree from
    ``sharding.distribute_cohort``, the new model a DTensor tree); any
    other policy runs the whole cohort here.
    """
    sharded = getattr(policy, "device_mesh", None) is not None
    tp = _model_live(policy)
    legacy = {"agg_engine": agg_engine, "agg_block_n": agg_block_n,
              "comm_dtype": comm_dtype, "quant_block": quant_block}
    if any(v is not None for v in legacy.values()):
        if engine is not None:
            raise ValueError(
                "pass either engine= (an EngineSpec) or the legacy "
                f"agg kwargs, not both (got both engine and "
                f"{[k for k, v in legacy.items() if v is not None]})")
        warnings.warn(
            "make_fed_round_step(agg_engine=..., comm_dtype=...) loose "
            "kwargs are deprecated; pass engine=EngineSpec(...)",
            DeprecationWarning, stacklevel=2)
        engine = aggregate.EngineSpec(
            engine=agg_engine or "flat", algorithm="fedhen",
            block_n=2048 if agg_block_n is None else agg_block_n,
            wire=comm.WireSpec(comm_dtype or "float32",
                               128 if quant_block is None else quant_block))
    spec = engine if engine is not None else aggregate.EngineSpec(
        algorithm="fedhen", wire=comm.WireSpec("float32", 128))
    if spec.wire is None:
        spec = spec.bind(wire=comm.WireSpec("float32", 128))
    adapter = LMAdapter(cfg, policy=policy.model_policy() if tp else policy,
                        remat=True)
    obs = obslib.coalesce(telemetry)
    if obs.enabled:
        values = {"local_steps": int(local_steps), "lr": lr,
                  "clip_norm": clip_norm,
                  "cohort_chunk": int(cohort_chunk),
                  "staleness_scheme": staleness_scheme,
                  "staleness_decay": staleness_decay}
        values.update(aggregate.engine_attrs(spec))
        obs.ledger("round_step_build", values)
    # the step folds no control variates (the reference's round step
    # passes no cv_chunk, and its finalize never reads cv_acc): the
    # engine's state leaves SCAFFOLD's zero accumulator out, which no
    # fold, result or all-reduce then carries
    spec = spec.bind(variance_reduction="none")

    def client_train(client: Tree, data: torch.Tensor, is_simple: bool):
        """One client's ``local_steps`` SGD steps on its ``(B,
        local_steps, S+1)`` block; returns ``(params, loss_side of the
        last step)``."""
        p = tree_map(lambda x: x.detach().clone(), client)
        b = data.shape[0]
        loss = None
        for i in range(local_steps):
            batch = {"tokens": data[min(i, b - 1)]}
            if is_simple:
                _, grads = _value_and_grad(adapter.loss_simple, p, batch)
                with torch.no_grad():
                    loss = adapter.loss_side(p, batch)
            else:
                loss, grads = _value_and_grad(adapter.loss_side, p, batch)
            p = _sgd(p, grads, lr, clip_norm)
        return p, loss

    def round_step(cohort: Tree, data: torch.Tensor, is_simple: torch.Tensor,
                   flat_mask: Optional[torch.Tensor] = None,
                   staleness=None, real: Optional[torch.Tensor] = None):
        k = data.shape[0]
        chunk = k if cohort_chunk <= 0 else cohort_chunk
        if k % chunk:
            raise ValueError(
                f"cohort_chunk={chunk} does not divide cohort size {k}")
        if tp:
            # each rank folds its local shards (module docstring)
            held = _ModelAxisCohort(cohort, policy)
            template, client_of = held.template, held.client
            if spec.wire.is_quantized:
                sharding.check_groups(held.template_dtensors(),
                                      spec.wire.quant_block)
        else:
            template = tree_map(lambda x: x[0], cohort)

            def client_of(z):
                return tree_map(lambda x: x[z], cohort)
        device = data.device
        mask = masking.transformer_subnet_mask(template, cfg)
        # both engines fold against the flat mask (K1/K2, or K4's)
        layout = flatten.layout_of(template, total_multiple=spec.block_n)
        if flat_mask is None:
            flat_mask = flatten.pack_mask(layout, mask, device)
        agg_init, agg_fold, agg_finalize = aggregate.make_engine(
            spec.bind(mask=mask, layout=layout, flat_mask=flat_mask))

        if staleness is None:
            st_w = torch.ones((k,), dtype=torch.float32)
        else:
            st_w = async_rounds.staleness_weight(
                torch.as_tensor(staleness).cpu(), scheme=staleness_scheme,
                decay=staleness_decay)
        st_w = st_w.to(device)
        if real is not None:
            real_f = real.to(device=device, dtype=torch.float32)
            st_w = st_w * real_f
            denom = torch.clamp(real_f.sum(), min=1.0)
        else:
            denom = torch.tensor(float(k), dtype=torch.float32,
                                 device=device)
        # host reads of the flags come from the tensor as given: a dry-run
        # passes them on the CPU beside meta tensors
        flags = is_simple
        is_simple = is_simple.to(device)
        # the rows of each chunk this rank trains: all of them, or its
        # Shard(0) share of the chunk's client axis over the data axes
        rows = [(start, start + chunk) for start in range(0, k, chunk)]
        if sharded:
            rows = [tuple(start + r for r in policy.data_rows(chunk))
                    for start, _ in rows]
            mine = [z for lo, hi in rows for z in range(lo, hi)]
            simple_host = dict(zip(mine, flags[mine].tolist()))
        else:
            simple_host = flags.tolist()

        state = agg_init(template)
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        for lo, hi in rows:
            if hi == lo:
                continue
            with _tp(policy):
                trained = [client_train(client_of(z), data[z],
                                        simple_host[z])
                           for z in range(lo, hi)]
            valid = torch.stack([masking.tree_isfinite(p)
                                 for p, _ in trained])
            losses = torch.stack([_value(loss).to(torch.float32)
                                  for _, loss in trained])
            trained = [sharding.local_tree(p) for p, _ in trained]
            # a chunk of one is a view of its client, not a copy (a
            # full-width LM client is 5 GB)
            stacked = tree_map(
                lambda *xs: xs[0][None] if len(xs) == 1
                else torch.stack(xs), *trained)
            del trained
            sl = slice(lo, hi)
            state = agg_fold(state, stacked, is_simple[sl],
                             valid.to(torch.float32) * st_w[sl])
            del stacked
            if real is not None:
                losses = torch.where(real_f[sl] > 0, losses, 0.0)
            loss_sum = loss_sum + losses.sum()
        if sharded and not (tp and policy.data_coordinate()[1] == 1):
            aggregate.allreduce_state(state, policy.data_group(), loss_sum)
        new_complex, _ = agg_finalize(state, template=template)
        if tp:
            new_complex = held.wrap(new_complex)
        return new_complex, loss_sum / denom

    return round_step


def make_prefill_step(cfg: ModelConfig, policy: Policy = NO_POLICY, *,
                      window_override: Optional[int] = None,
                      cache_len: Optional[int] = None):
    """``prefill_step(params, batch) -> (logits, cache)``; ``batch`` holds
    ``tokens`` and optionally a frontend's ``extra_embeds``."""
    def prefill_step(params: Tree, batch: Batch):
        with torch.no_grad(), _tp(policy):
            logits, cache = tfm.prefill(
                params, cfg, batch["tokens"],
                extra_embeds=batch.get("extra_embeds"), policy=policy,
                window_override=window_override, cache_len=cache_len)
            if sharding.is_dtensor(logits):
                cache = tree_map(policy.place, cache, sharding.cache_specs(
                    cache, cfg, policy.mesh))
            return logits, cache

    return prefill_step


def make_serve_step(cfg: ModelConfig, policy: Policy = NO_POLICY, *,
                    window_override: Optional[int] = None,
                    with_exit_head: bool = False):
    """``serve_step(params, cache, batch, pos) -> (logits, cache[,
    exit_logits])`` for one token at position ``pos`` (a Python int); the
    port's decode updates ``cache`` in place and returns it.

    Over a live model axis larger than 1 it takes the parameters as
    DTensors (``sharding.distribute_params``) and the cache as
    ``make_prefill_step`` hands it back, placed by ``sharding.cache_specs``
    (heads, head dim, ``kv_seq`` rows or ``rnn`` channels); each rank
    updates its local shards in place, and the logits and the exit logits
    come back vocab-parallel, as prefill's do.  A config out of scope
    there raises where its ``MeshPolicy`` is built."""
    def serve_step(params: Tree, cache: Tree, batch: Batch, pos: int):
        with torch.no_grad(), _tp(policy):
            return tfm.decode_step(params, cache, cfg, batch["tokens"], pos,
                                   policy=policy,
                                   window_override=window_override,
                                   with_exit_head=with_exit_head)

    return serve_step


def step_for_shape(cfg: ModelConfig, shape: InputShape,
                   policy: Policy = NO_POLICY, *,
                   window_override: Optional[int] = None,
                   side_objective: bool = True):
    """The step function a given input shape exercises."""
    if shape.kind == "train":
        return make_train_step(cfg, policy, side_objective=side_objective)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, policy,
                                 window_override=window_override)
    return make_serve_step(cfg, policy, window_override=window_override)
