"""GQA attention: global/sliding-window, RoPE, softcap, KV caches, decode.

The port of ``repro.models.attention``.  Three regimes share the
parameters, and the caller picks one:

* ``train`` — :func:`apply_attention_train`, the reference's training
  path: :func:`chunked_causal_attention`, plain PyTorch under autograd,
  each query chunk of a long sequence under ``torch.utils.checkpoint``
  as the reference's chunk bodies are under ``jax.checkpoint``.
* ``prefill`` — :func:`apply_attention` hands q, k and v to
  ``kernels.flash_attention.ops.flash_attention``: K5 on the card, its
  plain version on the CPU.  That is the function the reference's
  ``ops.flash_attention`` gives its Pallas kernel on a TPU, with the same
  contract as :func:`chunked_causal_attention`; it has no backward and
  raises on tensors that require grad.
* ``decode`` — one query token against a KV cache (:func:`_attend`, plain
  PyTorch, as in the reference).  Local layers keep a ring-buffer cache of
  size ``window`` (RoPE is applied at write time, so ring rotation is
  harmless); global layers keep the full cache.  The port updates the
  cache in place (the reference returns a new one).

The reference's ``chunk2d_attention`` is mesh-only and is not ported yet
(ROADMAP.md §1).  Shapes: hidden (B, S, D); q (B, S, H, Dh); k/v
(B, S, Kh, Dh).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import common

NEG_INF = -2.0 ** 30  # large-but-finite: keeps fully-masked rows NaN-free


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_attention(generator: torch.Generator, cfg: ModelConfig) -> dict:
    d, h, kh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    dh = cfg.resolved_head_dim
    dt = cfg.torch_param_dtype()
    p = {"wq": common.dense_init(generator, (d, h, dh), fan_in=d, dtype=dt),
         "wk": common.dense_init(generator, (d, kh, dh), fan_in=d, dtype=dt),
         "wv": common.dense_init(generator, (d, kh, dh), fan_in=d, dtype=dt),
         "wo": common.dense_init(generator, (h, dh, d), fan_in=h * dh,
                                 dtype=dt)}
    if cfg.use_qk_norm:
        p["q_norm"] = common.init_rmsnorm(dh, dt, generator.device)
        p["k_norm"] = common.init_rmsnorm(dh, dt, generator.device)
    return p


# ---------------------------------------------------------------------------
# Core masked attention over an explicit key block
# ---------------------------------------------------------------------------

def _attend(q, k, v, mask, softcap_val: float):
    """q: (B, Sq, Kh, G, Dh); k/v: (B, Sk, Kh, Dh); mask: (B|1, Sq, Sk).

    Scores in f32 (the reference's ``preferred_element_type``), softmax
    in f32, probabilities rounded to ``v.dtype`` before the PV product."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale
    logits = common.softcap(logits, softcap_val)
    logits = torch.where(mask[:, None, None, :, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)


def _split_gqa(q, n_kv: int):
    b, s, h, dh = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, dh)


def _merge_gqa(o):
    b, s, kh, g, dh = o.shape
    return o.reshape(b, s, kh * g, dh)


# ---------------------------------------------------------------------------
# Chunked causal attention (plain; the reference's train / prefill path)
# ---------------------------------------------------------------------------

def _attend_remat(q, k, v, mask, softcap_val: float):
    """:func:`_attend` recomputed in the backward pass: only q, k, v and
    the mask are kept, not the chunk's f32 scores and probabilities."""
    return checkpoint(_attend, q, k, v, mask, softcap_val,
                      use_reentrant=False)


def chunked_causal_attention(q, k, v, *, window: int = 0,
                             softcap_val: float = 0.0,
                             q_chunk: int = 512) -> torch.Tensor:
    """Causal (optionally sliding-window) attention without an S^2 buffer.

    q: (B, S, H, Dh); k, v: (B, S, Kh, Dh).  ``window`` == 0 means global
    causal.  A query at position i sees keys j with j <= i and, when
    windowed, i - j < window.  A sequence longer than ``q_chunk`` runs
    chunk by chunk, each chunk under ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint`` of its chunk bodies)."""
    b, s, h, dh = q.shape
    kh = k.shape[2]
    qg = _split_gqa(q, kh)
    dev = q.device

    if s <= q_chunk:
        pos = torch.arange(s, device=dev)
        mask = pos[None, :, None] >= pos[None, None, :]
        if window:
            mask &= (pos[None, :, None] - pos[None, None, :]) < window
        return _merge_gqa(_attend(qg, k, v, mask, softcap_val))

    if s % q_chunk:
        raise ValueError(f"seq {s} not divisible by q_chunk {q_chunk}")
    n_chunks = s // q_chunk
    outs = []
    if window and window + q_chunk < s:
        # Local: each chunk sees a static slice of window + chunk keys.
        span, pad = window + q_chunk, window
        kp = F.pad(k, (0, 0, 0, 0, pad, 0))
        vp = F.pad(v, (0, 0, 0, 0, pad, 0))
        for c in range(n_chunks):
            start = c * q_chunk                      # in padded coords
            q_pos = start + pad + torch.arange(q_chunk, device=dev)
            k_pos = start + torch.arange(span, device=dev)
            delta = q_pos[:, None] - k_pos[None, :]
            mask = (delta >= 0) & (delta < window) & (k_pos[None, :] >= pad)
            outs.append(_attend_remat(qg[:, start:start + q_chunk],
                               kp[:, start:start + span],
                               vp[:, start:start + span], mask[None],
                               softcap_val))
        return _merge_gqa(torch.cat(outs, dim=1))

    # Global causal: chunked queries against all keys.
    k_pos = torch.arange(s, device=dev)
    for c in range(n_chunks):
        q_pos = c * q_chunk + torch.arange(q_chunk, device=dev)
        mask = q_pos[:, None] >= k_pos[None, :]
        if window:
            mask &= (q_pos[:, None] - k_pos[None, :]) < window
        outs.append(_attend_remat(qg[:, c * q_chunk:(c + 1) * q_chunk], k, v,
                           mask[None], softcap_val))
    return _merge_gqa(torch.cat(outs, dim=1))


# ---------------------------------------------------------------------------
# Full layer application
# ---------------------------------------------------------------------------

def _project_qkv(p, h_in, cfg: ModelConfig, positions):
    dt = h_in.dtype
    q = torch.einsum("bsd,dhk->bshk", h_in, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", h_in, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", h_in, p["wv"].to(dt))
    if cfg.use_qk_norm:
        q = common.apply_rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = common.apply_rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k = common.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def apply_attention_train(p: dict, h_in: torch.Tensor, cfg: ModelConfig, *,
                          window: int = 0) -> torch.Tensor:
    """Training path.  h_in: (B, S, D) -> (B, S, D), differentiable:
    :func:`chunked_causal_attention` in plain PyTorch, as the reference
    trains (it never reaches K5)."""
    s = h_in.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=h_in.device)
    q, k, v = _project_qkv(p, h_in, cfg, positions)
    out = chunked_causal_attention(q, k, v, window=window,
                                   softcap_val=cfg.attn_logit_softcap)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(out.dtype))


def apply_attention(p: dict, h_in: torch.Tensor, cfg: ModelConfig, *,
                    window: int = 0, positions: Optional[torch.Tensor] = None,
                    q_chunk: int = 512, return_kv: bool = False):
    """Prefill path.  h_in: (B, S, D) -> (B, S, D), attention through
    ``flash_attention`` (K5 on the card).

    ``return_kv=True`` also returns the (RoPE'd) K/V tensors so the caller
    can build a decode cache.  Like the reference's chunked path, a
    sequence longer than ``q_chunk`` must be a multiple of it."""
    b, s, _ = h_in.shape
    if s > q_chunk and s % q_chunk:
        raise ValueError(f"seq {s} not divisible by q_chunk {q_chunk}")
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=h_in.device)
    q, k, v = _project_qkv(p, h_in, cfg, positions)
    out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                          window=window, softcap=cfg.attn_logit_softcap)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(out.dtype))
    if return_kv:
        return out, k, v
    return out


def kv_to_cache(k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig, *,
                window: int = 0, cache_len: Optional[int] = None) -> dict:
    """Arrange prefill K/V (B, S, Kh, Dh) into a decode cache.

    Windowed layers get a ring buffer laid out so that position p sits at
    slot p % size — what :func:`apply_attention_decode` expects when it
    continues from pos = S.  Global layers get a dense cache of
    ``cache_len`` (>= S) slots."""
    b, s, kh, dh = k.shape
    dt = cfg.torch_compute_dtype()
    size = cache_len or s
    start = 0
    if window:
        size = min(window, size)
        start = max(s - size, 0)
    ck = torch.zeros((b, size, kh, dh), dtype=dt, device=k.device)
    cv = torch.zeros_like(ck)
    slots = (start + torch.arange(s - start, device=k.device)) % size
    ck[:, slots] = k[:, start:].to(dt)
    cv[:, slots] = v[:, start:].to(dt)
    return {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# KV cache (decode)
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: ModelConfig, batch: int, seq_len: int, *,
                  window: int = 0, device=None) -> dict:
    """window > 0 -> ring buffer of that size; else dense cache of seq_len."""
    size = min(window, seq_len) if window else seq_len
    shape = (batch, size, cfg.n_kv_heads, cfg.resolved_head_dim)
    dt = cfg.torch_compute_dtype()
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def apply_attention_decode(p: dict, h_in: torch.Tensor, cache: dict,
                           pos: int, cfg: ModelConfig, *, window: int = 0):
    """One-token decode.  h_in: (B, 1, D); pos: the current index.

    Writes the token's K/V into ``cache`` in place and returns
    ``(out (B, 1, D), cache)``."""
    b = h_in.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=h_in.device)
    q, k_new, v_new = _project_qkv(p, h_in, cfg, positions)

    size = cache["k"].shape[1]
    slot = pos % size if window else pos
    if slot >= size:
        raise ValueError(f"position {pos} beyond the global cache's {size} "
                         f"slots (size the cache by prompt + generated)")
    cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)

    idx = torch.arange(size, device=h_in.device)
    if window:
        # slot j holds the largest logical position p' <= pos with
        # p' % size == j
        logical = pos - torch.remainder(pos - idx, size)
        valid = (logical >= 0) & (logical <= pos) & (pos - logical < window)
    else:
        valid = idx <= pos
    out = _attend(_split_gqa(q, cfg.n_kv_heads), cache["k"], cache["v"],
                  valid[None, None, :], cfg.attn_logit_softcap)
    out = _merge_gqa(out)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(out.dtype))
    return out, cache
