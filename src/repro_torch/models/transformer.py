"""Decoder-stack assembly: training forward, prefill, decode and the
FedHeN exit head.

The port of ``repro.models.transformer``.  The stack is ``n_periods``
repetitions of the config's ``pattern`` (the reference's ``lax.scan`` over
stacked parameters becomes a Python loop over the periods' blocks) plus
``n_remainder`` tail layers.  The FedHeN simple sub-network is the depth
prefix ``blocks[:exit_layer]``; its activation after ``exit_period``
periods feeds the early-exit head (own norm, shared unembedding).

Training (:func:`forward`, :func:`forward_simple`) runs every block
through its differentiable plain path (``attention.apply_attention_train``,
``rglru.apply_rglru_train``, the xLSTM blocks' own forms); prefill runs K5
and K6 (the xLSTM blocks have no kernel).  Under autograd a
period's block comes from ONE ``torch.unbind`` per stacked leaf
(:func:`_periods`): each ``x[i]`` would cost a full-size zero-filled
``select_backward`` per period per leaf, where ``unbind``'s backward
stacks the periods' gradients once.

Parameter tree, the reference's (leaf order and shapes):

    {"embed":   {"table": (V, D)} | {"tables": (n_codebooks, V, D)},
     "frontend_proj": {"w": (d_in, D)}?,            # VLM / audio projector
     "periods": (p0, p1, ... p_{period-1})          # leaves (n_periods, ...)
     "rem":     (layer trees ...),                  # unrolled tail
     "exit_norm":  rmsnorm,                         # FedHeN early-exit head
     "final_norm": rmsnorm,
     "unembed": {"w": (D, V)}?}                     # untied configs only

Caches mirror the periods/rem structure; decode updates them in place.
Ported mixers: attention (global and local), RG-LRU and the xLSTM blocks
(mLSTM and sLSTM, ``models/xlstm.py``), with the dense MLP,
Mixture-of-Experts (``mlp.apply_moe``, given the policy at the reference's
call sites) or none.  Each block returns the MoE aux losses (zeros for a
dense block); :func:`forward` sums them over the stack, the other paths
drop them, as the reference's do.  An MoE block routes each sequence as
its own group, except in decode, which routes the whole batch as one group
(``x.reshape(1, B * S, D)``), as the reference does.

A multi-codebook config (musicgen-large) takes ``(B, S, n_codebooks)``
tokens: the codebooks' embeddings are summed and the logits are
``(B, S, n_codebooks, V)``, one head per codebook over the tied tables.
A config with a frontend (the VLM and audio stubs) takes ``extra_embeds``
``(B, N, d_in)`` in :func:`forward`, :func:`forward_simple` and
:func:`prefill`: projected by ``frontend_proj`` and prepended to the
sequence, so the hidden states and logits cover ``N + S`` positions.
Decode takes no frontend, as the reference's does.

The entry points take the reference's sharding ``policy`` (default
:data:`common.NO_POLICY`) and constrain the same activations; the blocks
hand it to attention, whose ``seq2d`` branch runs ``chunk2d_attention``
(in prefill only on ``meta``; with values prefill keeps K5), and to the
xLSTM mixers.  Under a live token split (``MeshPolicy.token_split``: the
``seq2d`` / ``dp2d`` / ``seq2d_fsdp`` configs over a model axis) each
block runs on each rank's tokens in one ``local_map``
(:func:`_split_block`), the embedding's ``Partial`` is reduced then split,
and the heads gather the sequence first (:func:`_whole_sequence`).
:func:`abstract_params` and ``init_cache(..., device="meta")`` give the
trees of :func:`init_params` and :func:`init_cache` as ``meta`` tensors,
the counterpart of the reference's ``jax.eval_shape`` of them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, MLP_DENSE,
                                      MLP_MOE, MLSTM, RGLRU, SLSTM,
                                      LayerSpec, ModelConfig)
from repro_torch.models import attention, common, mlp, rglru, xlstm
from repro_torch.models.common import NO_POLICY, Policy
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

Params = Dict[str, Any]


def _window(spec: LayerSpec, cfg: ModelConfig,
            window_override: Optional[int]) -> int:
    if window_override is not None:
        return window_override
    return cfg.window if spec.mixer == ATTN_LOCAL else 0


def _is_attention(spec: LayerSpec) -> bool:
    return spec.mixer in (ATTN_GLOBAL, ATTN_LOCAL)


def _index(tree, i: int):
    """Views of one period's block in a stacked tree."""
    return tree_map(lambda x: x[i], tree)


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _draw_stacked(make, n: int):
    """``n`` trees from ``make()``, in order, stacked leaf by leaf.  Each
    is copied into the stack as it is drawn, so the peak is the stack and
    one block, not every block and their stack; one block is a view (a
    kimi-k2 block at published widths is 36.5 GB)."""
    first = make()
    if n == 1:
        return tree_map(lambda x: x.unsqueeze(0), first)
    leaves, treedef = tree_flatten(first)
    stacked = [x.new_empty((n,) + tuple(x.shape)) for x in leaves]
    for out, x in zip(stacked, leaves):
        out[0].copy_(x)
    del first, leaves
    for i in range(1, n):
        for out, x in zip(stacked, tree_flatten(make())[0]):
            out[i].copy_(x)
    return tree_unflatten(treedef, stacked)


def _periods(params: Params) -> List[List[Params]]:
    """Each period's blocks, in pattern order, from one ``torch.unbind``
    per stacked leaf (see the module docstring)."""
    by_pos = []
    for stacked in params["periods"]:
        leaves, treedef = tree_flatten(stacked)
        cols = [torch.unbind(x, 0) for x in leaves]
        by_pos.append([tree_unflatten(treedef, [c[i] for c in cols])
                       for i in range(len(cols[0]) if cols else 0)])
    return [list(blocks) for blocks in zip(*by_pos)]


# ---------------------------------------------------------------------------
# Block init / apply
# ---------------------------------------------------------------------------

def init_block(generator: torch.Generator, spec: LayerSpec,
               cfg: ModelConfig) -> Params:
    dt = cfg.torch_param_dtype()
    dev = generator.device
    p: Params = {"pre_norm": common.init_rmsnorm(cfg.d_model, dt, dev)}
    if _is_attention(spec):
        p["mixer"] = attention.init_attention(generator, cfg)
    elif spec.mixer == RGLRU:
        p["mixer"] = rglru.init_rglru(generator, cfg)
    elif spec.mixer == MLSTM:
        p["mixer"] = xlstm.init_mlstm(generator, cfg)
    else:
        p["mixer"] = xlstm.init_slstm(generator, cfg)
    if spec.mlp == MLP_DENSE:
        p["mlp_norm"] = common.init_rmsnorm(cfg.d_model, dt, dev)
        p["mlp"] = mlp.init_mlp(generator, cfg)
    elif spec.mlp == MLP_MOE:
        p["mlp_norm"] = common.init_rmsnorm(cfg.d_model, dt, dev)
        p["mlp"] = mlp.init_moe(generator, cfg)
    return p


def _zero_aux(device) -> Dict[str, torch.Tensor]:
    return {"load_balance": torch.zeros((), device=device),
            "router_z": torch.zeros((), device=device)}


def _apply_mlp(p: Params, spec: LayerSpec, h: torch.Tensor,
               cfg: ModelConfig, *, one_group: bool = False,
               policy: Policy = NO_POLICY):
    """The block's MLP half: ``(h + mlp(norm(h)), aux)``.  An MoE block
    routes each row of the batch as a group, or with ``one_group`` the
    whole batch as one (decode): where the batch is sharded that group
    spans the ranks, and each rank routes its rows with the queue offsets
    of the ranks before it, or the rows are gathered where the experts are
    split over the batch's dims too (``mlp.apply_moe``).  Over
    a model axis the MLP's output is a ``Partial`` sum (the dense down
    projection is row-parallel, the experts' combine adds each rank's
    experts or ffn shard), reduced by the constrain before the residual
    add."""
    aux = _zero_aux(h.device)
    if "mlp" not in p:
        return h, aux
    x = common.apply_rmsnorm(p["mlp_norm"], h, cfg.norm_eps)
    if spec.mlp == MLP_MOE:
        y, aux = mlp.apply_moe(p["mlp"], x, cfg, policy, one_group=one_group)
    else:
        y = mlp.apply_mlp(p["mlp"], x, policy)
    return h + policy.constrain(y, ("batch", "seq", None)), aux


def _token_split(policy: Policy, h) -> bool:
    return policy.token_split and common.is_dtensor(h)


def _whole_sequence(h, policy: Policy):
    """A token split's hidden state gathered along the sequence (one
    all-reduce) for the heads: their constrain puts vocab before seq (the
    reference's priority), and a loss slices the sequence.  ``h`` as it is
    under any other policy."""
    if not _token_split(policy, h):
        return h
    return policy.constrain(h, ("batch", None, None))


def _split_block(run, p: Params, h, policy: Policy, n_extra: int = 0):
    """``run(p, h, split)`` -- a block's plain code, ``split`` its
    :class:`common.TokenSplit` -- on each rank's tokens of a live token
    split, in one ``local_map``: the hidden state (B, S, D) split over the
    sequence (``seq2d``) or the batch (``dp2d``), the block's weights whole
    (replicated, or gathered over data under ``seq2d_fsdp``).  ``run``
    returns the block's new hidden state, its aux losses (an MoE block's
    are the whole batch's on every rank, ``mlp.apply_moe``) and
    ``n_extra`` further outputs (prefill's cache).  Returns the hidden
    state placed as ``h``, the aux replicated, and the further outputs
    whole along the sequence and placed as ``h``'s batch.  A weight's
    local gradient is this rank's tokens' term: ``Partial`` over each mesh
    dim that splits the tokens, whole where every rank of a dim holds the
    same tokens."""
    from torch.distributed.tensor import Partial, Replicate
    p = policy.gather_weights(p)
    leaves, treedef = tree_flatten(p)
    split = policy.local_split(h)
    tokens = [i for i, pl in enumerate(h.placements) if pl.is_shard()]
    grads = [[Partial() if i in tokens else pl
              for i, pl in enumerate(x.placements)]
             if common.is_dtensor(x) else None for x in leaves]
    batch = [pl if pl.is_shard(0) else Replicate() for pl in h.placements]
    whole = [Replicate()] * len(h.placements)

    def local(hl, *ws):
        out, aux, *extra = run(tree_unflatten(treedef, list(ws)), hl, split)
        return (out, aux["load_balance"], aux["router_z"], *extra)
    out, lb, z, *extra = common.local_apply(
        local, (list(h.placements), whole, whole) + (batch,) * n_extra, h,
        *leaves, in_grad_placements=(None, *grads))
    return (out, {"load_balance": lb, "router_z": z}, *extra)


def apply_block(p: Params, spec: LayerSpec, h: torch.Tensor,
                cfg: ModelConfig, *, window_override: Optional[int] = None,
                policy: Policy = NO_POLICY
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence training block, differentiable.  Returns ``(h,
    aux)``; ``aux`` holds the MoE losses, zeros for a dense block.  Under
    a live token split it runs on each rank's tokens
    (:func:`_split_block`)."""
    if _token_split(policy, h):
        return _split_block(lambda pl, hl, split: apply_block(
            pl, spec, hl, cfg, window_override=window_override,
            policy=split), p, h, policy)
    x = common.apply_rmsnorm(p["pre_norm"], h, cfg.norm_eps)
    if _is_attention(spec):
        m = attention.apply_attention_train(
            p["mixer"], x, cfg, window=_window(spec, cfg, window_override),
            policy=policy)
    elif spec.mixer == RGLRU:
        m = rglru.apply_rglru_train(p["mixer"], x, cfg, policy)
    elif spec.mixer == MLSTM:
        m = xlstm.apply_mlstm(p["mixer"], x, cfg, policy)
    else:
        m = xlstm.apply_slstm(p["mixer"], x, cfg, policy)
    m = policy.constrain(m, ("batch", "seq", None))
    h, aux = _apply_mlp(p, spec, h + m, cfg, policy=policy)
    return policy.constrain(h, ("batch", "seq", None)), aux


def apply_block_prefill(p: Params, spec: LayerSpec, h: torch.Tensor,
                        cfg: ModelConfig, *,
                        window_override: Optional[int] = None,
                        cache_len: Optional[int] = None,
                        policy: Policy = NO_POLICY):
    """Full-sequence block that also builds its decode cache.
    Returns ``(h, cache, aux)``.  Under a live token split it runs on each
    rank's tokens (:func:`_split_block`); the cache -- any mixer's tree,
    attention's k and v or the RG-LRU's state and conv rows -- comes back
    whole along the sequence, placed as the batch, and the aux
    replicated."""
    if _token_split(policy, h):
        shapes, treedef = tree_flatten(init_block_cache(
            spec, cfg, 1, 1, window_override=window_override,
            device="meta"))

        def run(pl, hl, split):
            out, cache, aux = apply_block_prefill(
                pl, spec, hl, cfg, window_override=window_override,
                cache_len=cache_len, policy=split)
            return (out, aux, *tree_flatten(cache)[0])
        h, aux, *leaves = _split_block(run, p, h, policy,
                                       n_extra=len(shapes))
        return h, tree_unflatten(treedef, leaves), aux
    x = common.apply_rmsnorm(p["pre_norm"], h, cfg.norm_eps)
    x = policy.constrain(x, ("batch", "seq", None))
    if _is_attention(spec):
        window = _window(spec, cfg, window_override)
        m, k, v = attention.apply_attention(p["mixer"], x, cfg, window=window,
                                            policy=policy, return_kv=True)
        cache = attention.kv_to_cache(k, v, cfg, window=window,
                                      cache_len=cache_len)
    elif spec.mixer == RGLRU:
        m, cache = rglru.apply_rglru(p["mixer"], x, cfg, return_state=True,
                                     policy=policy)
    elif spec.mixer == MLSTM:
        m, cache = xlstm.apply_mlstm(p["mixer"], x, cfg, policy,
                                     return_state=True)
    else:
        m, cache = xlstm.apply_slstm(p["mixer"], x, cfg, policy,
                                     return_state=True)
    m = policy.constrain(m, ("batch", "seq", None))
    h, aux = _apply_mlp(p, spec, h + m, cfg, policy=policy)
    return policy.constrain(h, ("batch", "seq", None)), cache, aux


def init_block_cache(spec: LayerSpec, cfg: ModelConfig, batch: int,
                     seq_len: int, *, window_override: Optional[int] = None,
                     device=None) -> Params:
    if _is_attention(spec):
        return attention.init_kv_cache(
            cfg, batch, seq_len, window=_window(spec, cfg, window_override),
            device=device)
    if spec.mixer == RGLRU:
        return rglru.init_rglru_cache(cfg, batch, device=device)
    if spec.mixer == MLSTM:
        return xlstm.init_mlstm_cache(cfg, batch, device=device)
    if spec.mixer == SLSTM:
        return xlstm.init_slstm_cache(cfg, batch, device=device)
    raise ValueError(spec.mixer)


def apply_block_decode(p: Params, spec: LayerSpec, h: torch.Tensor,
                       cache: Params, pos: int, cfg: ModelConfig, *,
                       window_override: Optional[int] = None,
                       policy: Policy = NO_POLICY):
    """One-token block; updates ``cache`` in place.  Returns
    ``(h, cache, aux)``; an MoE block routes the whole batch as one
    group.  Over a model axis the mixer's output (a ``Partial`` sum where
    ``wo`` or ``w_out`` is row-parallel) is reduced by the constrain
    before the residual add, as in prefill.  Under ``seq2d_fsdp`` the
    block's weights are gathered over data first."""
    p = policy.gather_weights(p)
    x = common.apply_rmsnorm(p["pre_norm"], h, cfg.norm_eps)
    if _is_attention(spec):
        m, cache = attention.apply_attention_decode(
            p["mixer"], x, cache, pos, cfg,
            window=_window(spec, cfg, window_override), policy=policy)
    elif spec.mixer == RGLRU:
        m, cache = rglru.apply_rglru_decode(p["mixer"], x, cache, cfg,
                                            policy)
    elif spec.mixer == MLSTM:
        m, cache = xlstm.apply_mlstm_decode(p["mixer"], x, cache, cfg,
                                            policy)
    else:
        m, cache = xlstm.apply_slstm_decode(p["mixer"], x, cache, cfg,
                                            policy)
    m = policy.constrain(m, ("batch", "seq", None))
    h, aux = _apply_mlp(p, spec, h + m, cfg, one_group=True, policy=policy)
    return h, cache, aux


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def init_params(generator: torch.Generator, cfg: ModelConfig) -> Params:
    """Random weights drawn from ``generator``, on its device (a CUDA
    generator initialises a full-width model on the card).  A
    multi-codebook embedding's tables are stacked as drawn."""
    dt = cfg.torch_param_dtype()
    dev = generator.device
    if cfg.n_codebooks > 1:
        params: Params = {"embed": {"tables": _draw_stacked(
            lambda: common.embed_init(generator, (cfg.vocab_size,
                                                  cfg.d_model), dt),
            cfg.n_codebooks)}}
    else:
        params = {"embed": common.init_embedding(
            generator, cfg.vocab_size, cfg.d_model, dt)}
    if cfg.frontend is not None:
        params["frontend_proj"] = {"w": common.dense_init(
            generator, (cfg.frontend.d_in, cfg.d_model), dtype=dt)}
    periods = []
    for spec in cfg.pattern:
        make = lambda spec=spec: init_block(generator, spec, cfg)  # noqa: E731
        periods.append(_draw_stacked(make, cfg.n_periods) if cfg.n_periods
                       else tree_map(lambda x: x[None][:0], make()))
    params["periods"] = tuple(periods)
    params["rem"] = tuple(init_block(generator, cfg.layer_spec(i), cfg)
                          for i in range(cfg.n_remainder))
    params["exit_norm"] = common.init_rmsnorm(cfg.d_model, dt, dev)
    params["final_norm"] = common.init_rmsnorm(cfg.d_model, dt, dev)
    if not cfg.tie_embeddings:
        params["unembed"] = {"w": common.dense_init(
            generator, (cfg.d_model, cfg.vocab_size), dtype=dt)}
    return params


def abstract_params(cfg: ModelConfig) -> Params:
    """The tree :func:`init_params` makes for ``cfg`` — the same leaves in
    the same order, shapes and dtypes — as ``meta`` tensors: nothing is
    allocated and nothing drawn (the init functions see a
    :class:`common.ShapeGenerator`)."""
    return init_params(common.ShapeGenerator(), cfg)


def embed_inputs(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 extra_embeds: Optional[torch.Tensor] = None,
                 policy: Policy = NO_POLICY) -> torch.Tensor:
    """tokens: (B, S) or (B, S, n_codebooks) -> (B, [N +] S, D) in the
    compute dtype.

    Codebooks: the tables' rows summed in the tables' dtype, codebook 0
    first, one rounding an add (the reference's ``sum(parts)``), times
    ``sqrt(d_model)`` rounded to that dtype; tables sharded over their
    vocabulary are looked up on each rank's rows
    (``common.codebook_lookup``) and reduced once before the adds.  ``extra_embeds`` (B, N,
    d_in): projected by ``frontend_proj`` in the compute dtype and
    prepended along the sequence."""
    cd = cfg.torch_compute_dtype()
    if cfg.n_codebooks > 1:
        tables = params["embed"]["tables"]
        if common.sharding_dims(tables, 1):
            # each (token, codebook) row is held by one rank: one
            # all-reduce of every codebook's rows is exact, and the adds
            # below are then the unsharded ones, bitwise
            rows = common.reduce_partial(common.codebook_lookup(tables,
                                                                tokens))
            parts = [rows[..., c, :] for c in range(cfg.n_codebooks)]
        else:
            tabs = torch.unbind(tables, 0)
            parts = [tabs[c][tokens[..., c]]
                     for c in range(cfg.n_codebooks)]
        h = parts[0]
        for part in parts[1:]:
            h = h + part
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32,
                             device=h.device).to(h.dtype)
    else:
        h = common.apply_embedding(params["embed"], tokens)
    if cfg.n_codebooks == 1 or _token_split(policy, h):
        # a vocab-parallel lookup's Partial sum, reduced (an all-reduce);
        # a token split splits the sequence after the frontend's rows
        h = policy.constrain(h, ("batch", None if extra_embeds is not None
                                 else "seq", None))
    h = h.to(cd)
    if extra_embeds is not None:
        proj = torch.matmul(extra_embeds.to(cd), policy.gather_weights(
            params["frontend_proj"])["w"].to(cd))
        if _token_split(policy, h):
            proj = policy.constrain(proj, ("batch", None, None))
        h = torch.cat([proj, h], dim=1)
    return policy.constrain(h, ("batch", "seq", None))


def logits_from_hidden(params: Params, cfg: ModelConfig, h: torch.Tensor,
                       head: str, policy: Policy = NO_POLICY) -> torch.Tensor:
    """head: 'final' or 'exit' (FedHeN early-exit head, shared
    unembedding).  (B, S, V), or (B, S, n_codebooks, V) with codebooks."""
    norm = params["final_norm"] if head == "final" else params["exit_norm"]
    h = _whole_sequence(h, policy)
    h = common.apply_rmsnorm(policy.gather_weights(norm), h, cfg.norm_eps)
    if cfg.n_codebooks > 1:
        tables = params["embed"]["tables"].to(h.dtype)      # (NC, V, D)
        nc, v, d = tables.shape
        if common.sharding_dims(tables, 1):
            logits = _codebook_logits_sharded(h, tables, policy)
        else:
            logits = torch.matmul(h, tables.reshape(nc * v, d).t()
                                  ).unflatten(-1, (nc, v))
    elif cfg.tie_embeddings:
        logits = common.apply_unembedding(
            {"table": params["embed"]["table"].to(h.dtype)}, h)
    else:
        logits = torch.matmul(h, policy.gather_weights(params["unembed"])[
            "w"].to(h.dtype))
    logits = common.softcap(logits, cfg.final_logit_softcap)
    return policy.constrain(logits, ("batch", "seq", "vocab"))


def _codebook_logits_sharded(h, tables, policy: Policy):
    """The codebook heads' (B, S, NC, V) logits from the vocab-sharded
    tables, placed as the reference's ``("batch", "seq", "vocab")``
    constrain resolves on them: the vocab rule lands on the codebook dim,
    so they are sharded over the codebooks where NC divides the model
    axis, and whole otherwise.  Redistributing vocab-parallel logits there
    would take an all-to-all or an all-gather; so each rank computes its
    vocabulary's logits of every codebook, the vocabulary is gathered by
    one all-reduce (``common.GatherBySum``) and the rank keeps its
    codebooks.  In the backward the codebooks' gradients are summed over
    the ranks that split them (an all-reduce), and ``h``'s gradient is
    ``Partial`` over the vocabulary's ranks."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.launch.sharding import shard_rows, to_placements
    mesh = tables.device_mesh
    nc, v, d = tables.shape
    vdims = common.sharding_dims(tables, 1)
    cdim = h.dim() - 1
    target = to_placements(policy.spec(tuple(h.shape[:-1]) + (nc, v), (
        "batch", "seq", "vocab")), policy.mesh)
    cdims = [i for i, pl in enumerate(target) if pl.is_shard(cdim)]
    c0, c1 = 0, nc
    for i in cdims:
        lo, hi = shard_rows(c1 - c0, mesh.get_local_rank(i), mesh.size(i))
        c0, c1 = c0 + lo, c0 + hi
    out = [Shard(cdim) if i in cdims else Replicate() if i in vdims else pl
           for i, pl in enumerate(h.placements)]
    h_grad = [Partial() if i in vdims else pl
              for i, pl in enumerate(h.placements)]
    t_grad = [Partial() if h.placements[i].is_shard() else pl
              for i, pl in enumerate(tables.placements)]
    v0 = common.shard_offset(tables, 1)

    def heads(hl, tl):
        vl = tl.shape[1]
        lv = torch.matmul(hl, tl.reshape(nc * vl, d).t()).unflatten(
            -1, (nc, vl))
        full = common.GatherBySum.apply(lv, cdim + 1, v0, v, mesh, vdims,
                                        cdims)
        return full.narrow(cdim, c0, c1 - c0)

    return common.local_apply(heads, out, h, tables,
                              in_grad_placements=(h_grad, t_grad))


def _merge_aux(a, b):
    return {k: a[k] + b[k] for k in a}


def _period(blocks, h, aux, cfg: ModelConfig,
            window_override: Optional[int], policy: Policy = NO_POLICY):
    """One period: the pattern's blocks in order."""
    for p, spec in zip(blocks, cfg.pattern):
        h, a = apply_block(p, spec, h, cfg, window_override=window_override,
                           policy=policy)
        aux = _merge_aux(aux, a)
    return h, aux


def _run_periods(periods: List[List[Params]], h, aux, cfg: ModelConfig, *,
                 remat: bool, window_override: Optional[int] = None,
                 exit_at: Optional[int] = None, policy: Policy = NO_POLICY):
    """Run the periods in order; each under ``torch.utils.checkpoint``
    when ``remat`` (the reference's ``jax.checkpoint`` of its scan body).
    Returns ``(h, aux, exit_h)``: ``exit_h`` is ``h`` after period
    ``exit_at - 1`` — the reference's ``where(idx == kp - 1, h, exit_h)``
    select, with the same gradient — or the embedding output when the
    loop never reaches it."""
    exit_h = h
    for i, blocks in enumerate(periods):
        if remat:
            h, aux = checkpoint(_period, blocks, h, aux, cfg,
                                window_override, policy, use_reentrant=False)
        else:
            h, aux = _period(blocks, h, aux, cfg, window_override, policy)
        if exit_at is not None and i == exit_at - 1:
            exit_h = h
    return h, aux, exit_h


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            extra_embeds: Optional[torch.Tensor] = None,
            policy: Policy = NO_POLICY, remat: bool = False,
            window_override: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Training forward: returns ``(exit_hidden, final_hidden, aux)``.

    ``exit_hidden`` is the activation after ``exit_period`` periods — the
    FedHeN simple sub-network's output stream, captured in the same pass
    (one forward, two heads)."""
    h = embed_inputs(params, cfg, tokens, extra_embeds, policy)
    h, aux, exit_h = _run_periods(
        _periods(params), h, _zero_aux(h.device), cfg, remat=remat,
        window_override=window_override, exit_at=cfg.exit_period,
        policy=policy)
    for i, p_rem in enumerate(params["rem"]):
        h, a = apply_block(p_rem, cfg.layer_spec(i), h, cfg,
                           window_override=window_override, policy=policy)
        aux = _merge_aux(aux, a)
    return (_whole_sequence(exit_h, policy), _whole_sequence(h, policy),
            aux)


def forward_simple(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   *, extra_embeds: Optional[torch.Tensor] = None,
                   policy: Policy = NO_POLICY, remat: bool = False
                   ) -> torch.Tensor:
    """Forward of the *simple* architecture only: the first
    ``exit_period`` periods.  ``params`` may be the complex tree or an
    extracted simple one (``masking.extract_simple``); only the prefix
    stacks are touched, so a stacked leaf's gradient is full-shape with
    zeros past the exit, and ``rem`` / ``final_norm`` get none."""
    h = embed_inputs(params, cfg, tokens, extra_embeds, policy)
    h, _, _ = _run_periods(_periods(params)[:cfg.exit_period], h,
                           _zero_aux(h.device), cfg, remat=remat,
                           policy=policy)
    return _whole_sequence(h, policy)


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            extra_embeds: Optional[torch.Tensor] = None,
            policy: Policy = NO_POLICY,
            window_override: Optional[int] = None,
            cache_len: Optional[int] = None):
    """Parallel prefill: returns ``(logits, cache)`` — every position's
    logits, as the reference returns them, and the decode cache.
    ``cache_len`` sizes the dense caches (>= prompt length, frontend
    positions included) to leave room for decoded tokens."""
    h = embed_inputs(params, cfg, tokens, extra_embeds, policy)
    per_pos = [[] for _ in cfg.pattern]
    for i in range(cfg.n_periods):
        for pos, spec in enumerate(cfg.pattern):
            h, c, _ = apply_block_prefill(
                _index(params["periods"][pos], i), spec, h, cfg,
                window_override=window_override, cache_len=cache_len,
                policy=policy)
            per_pos[pos].append(c)
    periods = []
    for spec, caches in zip(cfg.pattern, per_pos):
        periods.append(_stack(caches) if caches else tree_map(
            lambda x: x[None][:0], init_block_cache(
                spec, cfg, tokens.shape[0], cache_len or h.shape[1],
                window_override=window_override, device=tokens.device)))
    rem = []
    for i, p_rem in enumerate(params["rem"]):
        h, c, _ = apply_block_prefill(p_rem, cfg.layer_spec(i), h, cfg,
                                   window_override=window_override,
                                   cache_len=cache_len, policy=policy)
        rem.append(c)
    cache = {"periods": tuple(periods), "rem": tuple(rem)}
    return logits_from_hidden(params, cfg, h, "final", policy), cache


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
               window_override: Optional[int] = None, device=None) -> Params:
    periods = []
    for spec in cfg.pattern:
        one = init_block_cache(spec, cfg, batch, seq_len,
                               window_override=window_override, device=device)
        periods.append(tree_map(lambda x: x[None].repeat(
            (cfg.n_periods,) + (1,) * x.dim()), one))
    rem = tuple(init_block_cache(cfg.layer_spec(i), cfg, batch, seq_len,
                                 window_override=window_override,
                                 device=device)
                for i in range(cfg.n_remainder))
    return {"periods": tuple(periods), "rem": rem}


def decode_step(params: Params, cache: Params, cfg: ModelConfig,
                tokens: torch.Tensor, pos: int, *,
                policy: Policy = NO_POLICY,
                window_override: Optional[int] = None,
                with_exit_head: bool = False):
    """One decode step.  tokens: (B, 1) or (B, 1, n_codebooks); pos: the
    position being decoded (frontend positions included).

    Updates ``cache`` in place and returns ``(logits, cache[,
    exit_logits])``; the exit head reads the activation after
    ``exit_period`` periods."""
    h = embed_inputs(params, cfg, tokens, None, policy)
    exit_h = h
    for i in range(cfg.n_periods):
        for pos_i, spec in enumerate(cfg.pattern):
            h, _, _ = apply_block_decode(
                _index(params["periods"][pos_i], i), spec, h,
                _index(cache["periods"][pos_i], i), pos, cfg,
                window_override=window_override, policy=policy)
        if i == cfg.exit_period - 1:
            exit_h = h
    for i, p_rem in enumerate(params["rem"]):
        h, _, _ = apply_block_decode(p_rem, cfg.layer_spec(i), h,
                                     cache["rem"][i], pos, cfg,
                                     window_override=window_override,
                                     policy=policy)
    logits = logits_from_hidden(params, cfg, h, "final", policy)
    if with_exit_head:
        return logits, cache, logits_from_hidden(params, cfg, exit_h, "exit",
                                                 policy)
    return logits, cache
