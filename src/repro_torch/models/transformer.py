"""Decoder-stack assembly: prefill, decode and the FedHeN exit head.

The port of ``repro.models.transformer``'s serving path.  The stack is
``n_periods`` repetitions of the config's ``pattern`` (the reference's
``lax.scan`` over stacked parameters becomes a Python loop over views
``x[i]`` of the stacked leaves) plus ``n_remainder`` tail layers.  The
FedHeN simple sub-network is the depth prefix ``blocks[:exit_layer]``; its
activation after ``exit_period`` periods feeds the early-exit head (own
norm, shared unembedding).

Parameter tree, the reference's (leaf order and shapes):

    {"embed":   {"table": (V, D)},
     "periods": (p0, p1, ... p_{period-1})          # leaves (n_periods, ...)
     "rem":     (layer trees ...),                  # unrolled tail
     "exit_norm":  rmsnorm,                         # FedHeN early-exit head
     "final_norm": rmsnorm,
     "unembed": {"w": (D, V)}?}                     # untied configs only

Caches mirror the periods/rem structure; decode updates them in place.
Ported mixers: attention (global and local) and RG-LRU, with the dense
MLP.  xLSTM, MoE, multi-codebook embeddings and modality frontends raise
``NotImplementedError`` (ROADMAP.md §1); so do ``forward`` /
``forward_simple`` (the LM training slice).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, MLP_DENSE,
                                      MLP_NONE, RGLRU, LayerSpec,
                                      ModelConfig)
from repro_torch.models import attention, common, mlp, rglru
from repro_torch.tree import tree_map

Params = Dict[str, Any]


def _unported(what: str):
    return NotImplementedError(f"{what} is not ported to repro_torch yet "
                               f"(ROADMAP.md §1)")


def _check_spec(spec: LayerSpec) -> None:
    if spec.mixer not in (ATTN_GLOBAL, ATTN_LOCAL, RGLRU):
        raise _unported(f"the {spec.mixer} mixer")
    if spec.mlp not in (MLP_DENSE, MLP_NONE):
        raise _unported(f"the {spec.mlp} MLP")


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.n_codebooks > 1:
        raise _unported("multi-codebook embedding")
    if cfg.frontend is not None:
        raise _unported("the modality frontend")
    for spec in cfg.pattern:
        _check_spec(spec)


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


# ---------------------------------------------------------------------------
# Block init / apply
# ---------------------------------------------------------------------------

def init_block(generator: torch.Generator, spec: LayerSpec,
               cfg: ModelConfig) -> Params:
    _check_spec(spec)
    dt = cfg.torch_param_dtype()
    dev = generator.device
    p: Params = {"pre_norm": common.init_rmsnorm(cfg.d_model, dt, dev)}
    if _is_attention(spec):
        p["mixer"] = attention.init_attention(generator, cfg)
    else:
        p["mixer"] = rglru.init_rglru(generator, cfg)
    if spec.mlp == MLP_DENSE:
        p["mlp_norm"] = common.init_rmsnorm(cfg.d_model, dt, dev)
        p["mlp"] = mlp.init_mlp(generator, cfg)
    return p


def _apply_mlp(p: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if "mlp" in p:
        x = common.apply_rmsnorm(p["mlp_norm"], h, cfg.norm_eps)
        h = h + mlp.apply_mlp(p["mlp"], x)
    return h


def apply_block_prefill(p: Params, spec: LayerSpec, h: torch.Tensor,
                        cfg: ModelConfig, *,
                        window_override: Optional[int] = None,
                        cache_len: Optional[int] = None):
    """Full-sequence block that also builds its decode cache.
    Returns ``(h, cache)``."""
    x = common.apply_rmsnorm(p["pre_norm"], h, cfg.norm_eps)
    if _is_attention(spec):
        window = _window(spec, cfg, window_override)
        m, k, v = attention.apply_attention(p["mixer"], x, cfg, window=window,
                                            return_kv=True)
        cache = attention.kv_to_cache(k, v, cfg, window=window,
                                      cache_len=cache_len)
    else:
        m, cache = rglru.apply_rglru(p["mixer"], x, cfg, return_state=True)
    return _apply_mlp(p, h + m, cfg), cache


def init_block_cache(spec: LayerSpec, cfg: ModelConfig, batch: int,
                     seq_len: int, *, window_override: Optional[int] = None,
                     device=None) -> Params:
    if _is_attention(spec):
        return attention.init_kv_cache(
            cfg, batch, seq_len, window=_window(spec, cfg, window_override),
            device=device)
    if spec.mixer == RGLRU:
        return rglru.init_rglru_cache(cfg, batch, device=device)
    raise _unported(f"the {spec.mixer} mixer")


def apply_block_decode(p: Params, spec: LayerSpec, h: torch.Tensor,
                       cache: Params, pos: int, cfg: ModelConfig, *,
                       window_override: Optional[int] = None):
    """One-token block; updates ``cache`` in place.  Returns
    ``(h, cache)``."""
    x = common.apply_rmsnorm(p["pre_norm"], h, cfg.norm_eps)
    if _is_attention(spec):
        m, cache = attention.apply_attention_decode(
            p["mixer"], x, cache, pos, cfg,
            window=_window(spec, cfg, window_override))
    else:
        m, cache = rglru.apply_rglru_decode(p["mixer"], x, cache, cfg)
    return _apply_mlp(p, h + m, cfg), cache


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def init_params(generator: torch.Generator, cfg: ModelConfig) -> Params:
    """Random weights drawn from ``generator``, on its device (a CUDA
    generator initialises a full-width model on the card)."""
    _check_ported(cfg)
    dt = cfg.torch_param_dtype()
    dev = generator.device
    params: Params = {"embed": common.init_embedding(
        generator, cfg.vocab_size, cfg.d_model, dt)}
    periods = []
    for spec in cfg.pattern:
        blocks = [init_block(generator, spec, cfg)
                  for _ in range(cfg.n_periods)]
        periods.append(_stack(blocks) if blocks else tree_map(
            lambda x: x[None][:0], init_block(generator, spec, cfg)))
    params["periods"] = tuple(periods)
    params["rem"] = tuple(init_block(generator, cfg.layer_spec(i), cfg)
                          for i in range(cfg.n_remainder))
    params["exit_norm"] = common.init_rmsnorm(cfg.d_model, dt, dev)
    params["final_norm"] = common.init_rmsnorm(cfg.d_model, dt, dev)
    if not cfg.tie_embeddings:
        params["unembed"] = {"w": common.dense_init(
            generator, (cfg.d_model, cfg.vocab_size), dtype=dt)}
    return params


def embed_inputs(params: Params, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, S) -> (B, S, D) in the compute dtype."""
    _check_ported(cfg)
    h = common.apply_embedding(params["embed"], tokens)
    return h.to(cfg.torch_compute_dtype())


def logits_from_hidden(params: Params, cfg: ModelConfig, h: torch.Tensor,
                       head: str) -> torch.Tensor:
    """head: 'final' or 'exit' (FedHeN early-exit head, shared
    unembedding)."""
    norm = params["final_norm"] if head == "final" else params["exit_norm"]
    h = common.apply_rmsnorm(norm, h, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = common.apply_unembedding(
            {"table": params["embed"]["table"].to(h.dtype)}, h)
    else:
        logits = torch.matmul(h, params["unembed"]["w"].to(h.dtype))
    return common.softcap(logits, cfg.final_logit_softcap)


def forward(*args, **kwargs):
    raise _unported("the training forward (LM training slice)")


def forward_simple(*args, **kwargs):
    raise _unported("the simple-model training forward (LM training slice)")


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            window_override: Optional[int] = None,
            cache_len: Optional[int] = None):
    """Parallel prefill: returns ``(logits, cache)`` — every position's
    logits, as the reference returns them, and the decode cache.
    ``cache_len`` sizes the dense caches (>= prompt length) to leave room
    for decoded tokens."""
    h = embed_inputs(params, cfg, tokens)
    per_pos = [[] for _ in cfg.pattern]
    for i in range(cfg.n_periods):
        for pos, spec in enumerate(cfg.pattern):
            h, c = apply_block_prefill(
                _index(params["periods"][pos], i), spec, h, cfg,
                window_override=window_override, cache_len=cache_len)
            per_pos[pos].append(c)
    periods = []
    for spec, caches in zip(cfg.pattern, per_pos):
        periods.append(_stack(caches) if caches else tree_map(
            lambda x: x[None][:0], init_block_cache(
                spec, cfg, tokens.shape[0], cache_len or tokens.shape[1],
                window_override=window_override, device=tokens.device)))
    rem = []
    for i, p_rem in enumerate(params["rem"]):
        h, c = apply_block_prefill(p_rem, cfg.layer_spec(i), h, cfg,
                                   window_override=window_override,
                                   cache_len=cache_len)
        rem.append(c)
    cache = {"periods": tuple(periods), "rem": tuple(rem)}
    return logits_from_hidden(params, cfg, h, "final"), cache


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
                window_override: Optional[int] = None,
                with_exit_head: bool = False):
    """One decode step.  tokens: (B, 1); pos: the position being decoded.

    Updates ``cache`` in place and returns ``(logits, cache[,
    exit_logits])``; the exit head reads the activation after
    ``exit_period`` periods."""
    h = embed_inputs(params, cfg, tokens)
    exit_h = h
    for i in range(cfg.n_periods):
        for pos_i, spec in enumerate(cfg.pattern):
            h, _ = apply_block_decode(
                _index(params["periods"][pos_i], i), spec, h,
                _index(cache["periods"][pos_i], i), pos, cfg,
                window_override=window_override)
        if i == cfg.exit_period - 1:
            exit_h = h
    for i, p_rem in enumerate(params["rem"]):
        h, _ = apply_block_decode(p_rem, cfg.layer_spec(i), h,
                                  cache["rem"][i], pos, cfg,
                                  window_override=window_override)
    logits = logits_from_hidden(params, cfg, h, "final")
    if with_exit_head:
        return logits, cache, logits_from_hidden(params, cfg, exit_h, "exit")
    return logits, cache
