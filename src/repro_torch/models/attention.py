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

Both full-sequence paths take the reference's sharding ``policy``.  Under
a ``seq2d`` policy (``launch/sharding.MeshPolicy``) training runs
:func:`chunk2d_attention` instead, plain PyTorch as the reference computes
it in XLA ops: the reference's sequence-parallel form, whose query chunks
its policy shards over ``model``.  Prefill walks it on ``meta`` tensors
(the dry-runs); with values it keeps K5.  Under a live token split each
block runs on one rank's tokens (``common.TokenSplit``): q, k and v of its
rows at their positions, k and v gathered whole along the sequence by
all-reduces, then in training :func:`chunk2d_attention` (``seq2d``; its
fallbacks where the chunks do not divide S) or the chunked causal path
(``dp2d``) on its query rows, in prefill K5 on them with ``q_offset`` at
its first row.

Over a live model axis (DTensor parameters and activations) the attention
itself runs on each rank's local heads (:func:`_on_local_heads`, through
``local_map``): K5 in prefill, :func:`chunked_causal_attention` in
training.  With heads sharded (``attn_shard="auto"``) a rank holds ``H/m``
query heads and the ``Kh/m`` kv heads they read; with heads replicated
every rank computes the whole attention; with the head dim sharded
(llava's ``"head_dim"``) the function does not separate, so q, k and v are
gathered whole first, as GSPMD gathers around a custom call, and the
output is constrained back.  Decode reads the cache as
``sharding.cache_specs`` places it and never gathers it
(:func:`_attend_sharded`): heads on each rank's heads, the head dim by
all-reduced partial scores, ``kv_seq`` rows by a softmax merged with
all-reduces.  Shapes: hidden (B, S, D); q (B, S, H, Dh); k/v (B, S, Kh,
Dh).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import common
from repro_torch.models.common import NO_POLICY, Policy

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
                             q_chunk: int = 512,
                             q_offset: int = 0) -> torch.Tensor:
    """Causal (optionally sliding-window) attention without an S^2 buffer.

    q: (B, Sq, H, Dh), the rows at positions ``q_offset .. q_offset + Sq -
    1`` of a sequence (all of it by default; a rank's rows of a sequence
    split otherwise); k, v: (B, S, Kh, Dh), its keys from position 0.
    ``window`` == 0 means global causal.  A query at position i sees keys
    j with j <= i and, when windowed, i - j < window.  A sequence longer
    than ``q_chunk`` runs chunk by chunk of ``q_chunk`` query rows, each
    chunk under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint`` of its chunk bodies)."""
    sq = q.shape[1]
    s, kh = k.shape[1], k.shape[2]
    qg = _split_gqa(q, kh)
    dev = q.device

    if s <= q_chunk:
        q_pos = q_offset + torch.arange(sq, device=dev)
        k_pos = torch.arange(s, device=dev)
        mask = q_pos[None, :, None] >= k_pos[None, None, :]
        if window:
            mask &= (q_pos[None, :, None] - k_pos[None, None, :]) < window
        return _merge_gqa(_attend(qg, k, v, mask, softcap_val))

    if s % q_chunk:
        raise ValueError(f"seq {s} not divisible by q_chunk {q_chunk}")
    chunks = [(lo, min(lo + q_chunk, sq)) for lo in range(0, sq, q_chunk)]
    outs = []
    if window and window + q_chunk < s:
        # Local: each chunk sees a static slice of window + chunk keys.
        pad = window
        kp = F.pad(k, (0, 0, 0, 0, pad, 0))
        vp = F.pad(v, (0, 0, 0, 0, pad, 0))
        for lo, hi in chunks:
            start, span = q_offset + lo, window + hi - lo  # padded coords
            q_pos = start + pad + torch.arange(hi - lo, device=dev)
            k_pos = start + torch.arange(span, device=dev)
            delta = q_pos[:, None] - k_pos[None, :]
            mask = (delta >= 0) & (delta < window) & (k_pos[None, :] >= pad)
            outs.append(_attend_remat(qg[:, lo:hi],
                               kp[:, start:start + span],
                               vp[:, start:start + span], mask[None],
                               softcap_val))
        return _merge_gqa(torch.cat(outs, dim=1))

    # Global causal: chunked queries against all keys.
    k_pos = torch.arange(s, device=dev)
    for lo, hi in chunks:
        q_pos = q_offset + lo + torch.arange(hi - lo, device=dev)
        mask = q_pos[:, None] >= k_pos[None, :]
        if window:
            mask &= (q_pos[:, None] - k_pos[None, :]) < window
        outs.append(_attend_remat(qg[:, lo:hi], k, v, mask[None],
                                  softcap_val))
    return _merge_gqa(torch.cat(outs, dim=1))


def chunk2d_attention(q, k, v, *, window: int = 0, softcap_val: float = 0.0,
                      q_chunk: int = 512, k_chunk: int = 2048,
                      policy: Policy = NO_POLICY,
                      q_offset: int = 0) -> torch.Tensor:
    """Sequence-parallel flash attention in plain PyTorch (the reference's
    XLA-level form).

    q is reshaped to (B, NC, Lq, Kh, G, Dh), its chunk axis named
    ``seq_chunks`` for the policy; k and v are consumed whole.  An
    online-softmax loop over k-blocks of ``k_chunk`` keys bounds the live
    score tile: scores in f32, the running max and sum in f32, ``p`` cast
    to v's dtype before the PV product, which accumulates in f32.  When
    ``q_chunk`` or ``k_chunk`` does not divide S it falls back to
    :func:`chunked_causal_attention`, as the reference does.

    ``q_offset``: q (B, Sq, H, Dh) holds the rows at positions ``q_offset
    .. q_offset + Sq - 1`` of the sequence whose keys are k, v (B, S, Kh,
    Dh) -- a rank's query chunks under a live ``seq2d`` split, each row
    computed as the whole sequence's loop computes it (the same key
    blocks in the same order; its chunks whole ``q_chunk`` rows where Sq
    holds whole ones, else one chunk of Sq rows)."""
    b, sq, h, dh = q.shape
    s = k.shape[1]
    kh = k.shape[2]
    g = h // kh
    if s % q_chunk or s % k_chunk:
        return chunked_causal_attention(q, k, v, window=window,
                                        softcap_val=softcap_val,
                                        q_chunk=min(q_chunk, s),
                                        q_offset=q_offset)
    lq = q_chunk if sq % q_chunk == 0 else sq
    nc = sq // lq
    dev = q.device
    qc = q.reshape(b, nc, lq, kh, g, dh)
    qc = policy.constrain(qc, ("batch", "seq_chunks", None, None, None,
                               None)).float()
    scale = dh ** -0.5
    q_pos = (q_offset + torch.arange(nc, device=dev)[:, None] * lq
             + torch.arange(lq, device=dev)[None, :])           # (NC, Lq)
    shape5 = (b, nc, lq, kh, g)
    m = torch.full(shape5, NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(shape5, dtype=torch.float32, device=dev)
    acc = torch.zeros(shape5 + (dh,), dtype=torch.float32, device=dev)
    for kc in range(s // k_chunk):
        kb = k[:, kc * k_chunk:(kc + 1) * k_chunk]
        vb = v[:, kc * k_chunk:(kc + 1) * k_chunk]
        logits = torch.einsum("bnqkgd,bskd->bnqkgs", qc, kb.float()) * scale
        logits = common.softcap(logits, softcap_val)
        k_pos = kc * k_chunk + torch.arange(k_chunk, device=dev)
        delta = q_pos[..., None] - k_pos[None, None, :]
        mask = delta >= 0
        if window:
            mask &= delta < window
        logits = torch.where(mask[None, :, :, None, None, :], logits,
                             NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bnqkgs,bskd->bnqkgd", p.to(vb.dtype).float(), vb.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return _merge_gqa(out.to(q.dtype).reshape(b, sq, kh, g, dh))


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


def _seq2d(q, k, v, cfg: ModelConfig, window: int, q_chunk: int,
           policy: Policy):
    """The reference's ``seq2d`` branch: q, k and v constrained
    sequence-sharded, then k and v batch-sharded only, then
    :func:`chunk2d_attention`."""
    q = policy.constrain(q, ("batch", "seq", None, None))
    k = policy.constrain(k, ("batch", "seq", None, None))
    v = policy.constrain(v, ("batch", "seq", None, None))
    k = policy.constrain(k, ("batch", None, None, None))
    v = policy.constrain(v, ("batch", None, None, None))
    return chunk2d_attention(q, k, v, window=window,
                             softcap_val=cfg.attn_logit_softcap,
                             q_chunk=q_chunk, policy=policy)


def _heads(q, k, v, policy: Policy):
    return (policy.constrain(q, ("batch", "seq", "heads", "head_dim")),
            policy.constrain(k, ("batch", "seq", "kv_heads", "head_dim")),
            policy.constrain(v, ("batch", "seq", "kv_heads", "head_dim")))


def _on_local_heads(fn, q, k, v):
    """``fn(q, k, v) -> out`` (a per-head attention, output placed like q)
    on each rank's local heads.  Plain tensors go straight to ``fn``.  On
    DTensors the head dim is gathered whole first.  Query head ``h`` reads
    kv head ``h // G``: with q and k sharded alike each rank's ``H/m``
    query heads read its own ``Kh/m`` kv heads; with the query heads
    sharded and the kv heads replicated (``Kh`` does not divide ``m``) each
    rank reads the kv heads its query heads need, as GSPMD slices a
    replicated operand, and their gradients are ``Partial`` sums over the
    ranks; otherwise the heads are gathered whole."""
    if not common.is_dtensor(q):
        return fn(q, k, v)
    from torch.distributed.tensor import Partial
    q, k, v = (common.unshard(t, 3) for t in (q, k, v))
    h, kh = q.shape[2], k.shape[2]
    g = h // kh
    if list(k.placements) != list(v.placements):
        k, v = common.unshard(k, 2), common.unshard(v, 2)
    sharded = common.sharding_dims(q, 2)
    if list(q.placements) != list(k.placements) and len(sharded) == 1 and \
            not any(pl.is_shard(2) for pl in k.placements):
        i = sharded[0]
        hl, start = q.to_local().shape[2], common.shard_offset(q, 2)
        if hl % g == 0 or g % hl == 0:
            lo, hi = start // g, (start + hl - 1) // g + 1
            kv_grad = [Partial() if j == i else pl
                       for j, pl in enumerate(k.placements)]
            return common.local_apply(
                lambda q, k, v: fn(q, k[:, :, lo:hi], v[:, :, lo:hi]),
                list(q.placements), q, k, v,
                in_grad_placements=(None, kv_grad, kv_grad))
    if list(q.placements) != list(k.placements):
        q, k, v = (common.unshard(t, 2) for t in (q, k, v))
    hl, khl = q.to_local().shape[2], k.to_local().shape[2]
    if hl * kh != h * khl or hl % max(khl, 1):
        raise ValueError(f"local heads {hl} of {h} do not read whole kv "
                         f"groups ({khl} of {kh} kv heads)")
    return common.local_apply(fn, list(q.placements), q, k, v)


def _gather_kv(k, v, split: common.TokenSplit, grad: bool):
    """k and v (B, n, Kh, Dh) of this rank's rows whole along the sequence
    (one all-reduce each, :func:`common.gather_by_sum`); in training by
    :class:`common.GatherBySum`, whose backward sums their gradient over
    the ranks (each rank's query rows use them differently) and keeps this
    rank's rows."""
    if not split.dims:
        return k, v
    args = (1, split.start, split.size, split.mesh, split.dims)
    if grad:
        return (common.GatherBySum.apply(k, *args, split.dims),
                common.GatherBySum.apply(v, *args, split.dims))
    return common.gather_by_sum(k, *args), common.gather_by_sum(v, *args)


def _split_positions(h_in, split: common.TokenSplit) -> torch.Tensor:
    """This rank's absolute positions (RoPE's and the masks')."""
    return split.start + torch.arange(h_in.shape[1], dtype=torch.int32,
                                      device=h_in.device)


def _train_split(p, h_in, cfg: ModelConfig, window: int, q_chunk: int,
                 split: common.TokenSplit) -> torch.Tensor:
    """:func:`apply_attention_train` on one rank's tokens of a live token
    split: q, k and v of its rows, k and v gathered whole, then the
    reference's attention of those rows -- under ``seq2d``
    :func:`chunk2d_attention` of its query chunks at their positions (the
    reference's fallbacks where the chunks do not divide S), under ``dp2d``
    the chunked causal path of its whole sequences."""
    q, k, v = _project_qkv(p, h_in, cfg, _split_positions(h_in, split))
    k, v = _gather_kv(k, v, split, grad=True)
    kw = dict(window=window, softcap_val=cfg.attn_logit_softcap)
    if split.seq2d:
        out = chunk2d_attention(q, k, v, q_chunk=q_chunk,
                                q_offset=split.start, **kw)
    else:
        out = chunked_causal_attention(q, k, v, q_chunk=q_chunk, **kw)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(out.dtype))


def apply_attention_train(p: dict, h_in: torch.Tensor, cfg: ModelConfig, *,
                          window: int = 0, policy: Policy = NO_POLICY,
                          q_chunk: int = 512) -> torch.Tensor:
    """Training path.  h_in: (B, S, D) -> (B, S, D), differentiable:
    :func:`chunked_causal_attention` in plain PyTorch, as the reference
    trains (it never reaches K5), or :func:`chunk2d_attention` under a
    ``seq2d`` policy; on one rank's tokens of a live token split
    (:class:`common.TokenSplit`) :func:`_train_split`."""
    if isinstance(policy, common.TokenSplit):
        return _train_split(p, h_in, cfg, window, q_chunk, policy)
    s = h_in.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=h_in.device)
    h_in = policy.constrain(h_in, ("batch", "seq", None))
    q, k, v = _project_qkv(p, h_in, cfg, positions)
    if getattr(policy, "seq2d", False):
        out = _seq2d(q, k, v, cfg, window, q_chunk, policy)
    else:
        q, k, v = _heads(q, k, v, policy)
        out = _on_local_heads(
            lambda q, k, v: chunked_causal_attention(
                q, k, v, window=window, softcap_val=cfg.attn_logit_softcap,
                q_chunk=q_chunk), q, k, v)
    out = policy.constrain(out, ("batch", "seq", "heads", None))
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(out.dtype))


def apply_attention(p: dict, h_in: torch.Tensor, cfg: ModelConfig, *,
                    window: int = 0, policy: Policy = NO_POLICY,
                    positions: Optional[torch.Tensor] = None,
                    q_chunk: int = 512, return_kv: bool = False):
    """Prefill path.  h_in: (B, S, D) -> (B, S, D), attention through
    ``flash_attention`` (K5 on the card).  Under a ``seq2d`` policy on
    ``meta`` tensors (the dry-runs) it walks :func:`chunk2d_attention`,
    the program the reference lowers.  On tensors with values a ``seq2d``
    policy over plain tensors is the identity only where the sequence
    split is over axes of size 1 (and raises where it is not,
    ``MeshPolicy``), so the function is K5's and K5 computes it; on one
    rank's tokens of a live token split (:class:`common.TokenSplit`) it is
    :func:`_prefill_split`, K5 on the rank's query rows.

    ``return_kv=True`` also returns the (RoPE'd) K/V tensors so the caller
    can build a decode cache.  Like the reference's chunked path, a
    sequence longer than ``q_chunk`` must be a multiple of it."""
    b, s, _ = h_in.shape
    split = policy if isinstance(policy, common.TokenSplit) else None
    size = s if split is None else split.size
    if size > q_chunk and size % q_chunk:
        raise ValueError(f"seq {size} not divisible by q_chunk {q_chunk}")
    if split is not None:
        return _prefill_split(p, h_in, cfg, window, split, return_kv)
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=h_in.device)
    h_in = policy.constrain(h_in, ("batch", "seq", None))
    q, k, v = _project_qkv(p, h_in, cfg, positions)
    seq2d = getattr(policy, "seq2d", False)
    if seq2d and q.is_meta:
        out = _seq2d(q, k, v, cfg, window, q_chunk, policy)
    else:
        if seq2d:
            policy.constrain(q, ("batch", "seq", None, None))
        q, k, v = _heads(q, k, v, policy)
        out = _on_local_heads(
            lambda q, k, v: flash_attention(
                q.contiguous(), k.contiguous(), v.contiguous(),
                window=window, softcap=cfg.attn_logit_softcap), q, k, v)
    out = policy.constrain(out, ("batch", "seq", "heads", None))
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(out.dtype))
    if return_kv:
        return out, k, v
    return out


def _prefill_split(p, h_in, cfg: ModelConfig, window: int,
                   split: common.TokenSplit, return_kv: bool):
    """:func:`apply_attention` on one rank's tokens of a live token split:
    q, k and v of its rows, k and v gathered whole (one all-reduce each),
    then K5 on its query rows with ``q_offset`` at its first row against
    the key prefix those rows can see (on ``meta`` under ``seq2d``, the
    dry-runs, :func:`chunk2d_attention` of those rows: the program the
    reference lowers).  The k and v it returns are whole (the cache is
    built from them)."""
    q, k, v = _project_qkv(p, h_in, cfg, _split_positions(h_in, split))
    k, v = _gather_kv(k, v, split, grad=False)
    end = split.start + h_in.shape[1]
    if split.seq2d and q.is_meta:
        # the dry-runs walk the program the reference lowers
        out = chunk2d_attention(q, k, v, window=window,
                                softcap_val=cfg.attn_logit_softcap,
                                q_offset=split.start)
    else:
        out = flash_attention(q.contiguous(), k[:, :end].contiguous(),
                              v[:, :end].contiguous(), window=window,
                              softcap=cfg.attn_logit_softcap,
                              q_offset=split.start)
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
    ``cache_len`` (>= S) slots.  DTensor k and v are arranged on each
    rank's shards (the cache placed as k is)."""
    if common.is_dtensor(k):
        ck, cv = common.local_apply(
            lambda k, v: tuple(kv_to_cache(k, v, cfg, window=window,
                                           cache_len=cache_len).values()),
            (list(k.placements), list(v.placements)), k, v)
        return {"k": ck, "v": cv}
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


def _write_slot(c: torch.Tensor, new: torch.Tensor, slot: int) -> None:
    """Write ``new[:, 0]`` (B, 1, Kh, Dh) into global row ``slot`` of the
    cache leaf ``c`` in place.  A DTensor cache is written on its local
    shard by the rank whose rows hold ``slot`` (``shard_offset``), the new
    row placed as the cache but whole along the sequence."""
    if not common.is_dtensor(c):
        c[:, slot] = new[:, 0].to(c.dtype)
        return
    from torch.distributed.tensor import Replicate
    new = new.redistribute(c.device_mesh, [
        Replicate() if pl.is_shard(1) else pl for pl in c.placements])
    local = c.to_local()
    row = slot - common.shard_offset(c, 1)
    if 0 <= row < local.shape[1]:
        local[:, row] = new.to_local()[:, 0].to(local.dtype)


def _attend_sharded(q, k, v, valid: torch.Tensor, softcap_val: float):
    """:func:`_attend` of one query token against DTensor k/v (B, S, Kh,
    Dh) on each rank's local shards; q (B, 1, H, Dh) is placed as k, whole
    along the sequence and over a mesh dim of one rank (a relabelling:
    DTensor's einsum of the output with ``wo`` views a dim split over one
    rank, which it refuses, e.g. a batch of 1 over data of size 1).
    Returns the (B, 1, H, Dh) output, placed so.

    * heads sharded: each rank attends its heads (no collective);
    * head dim sharded: the scores are partial sums, all-reduced before
      the softmax;
    * sequence sharded (``kv_seq``): each rank scores its rows, masked by
      ``valid`` (the global slots' validity) at its offset, and the
      softmax is merged by all-reduces only: the MAX of the row maxima,
      the SUM of ``exp(s - max)``, then the SUM of the normalised
      probabilities (rounded to v's dtype, as ``_attend`` rounds them)
      times the local v, in f32.  ``NEG_INF`` is finite, so a rank whose
      rows are all masked scores ``exp(NEG_INF - max) = 0`` against the
      global max."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = k.device_mesh
    seq = common.sharding_dims(k, 1)
    dh = common.sharding_dims(k, 3)
    place = [Replicate() if pl.is_shard(1) or mesh.size(i) == 1 else pl
             for i, pl in enumerate(k.placements)]
    q = q.redistribute(mesh, place)
    ql, kl, vl = q.to_local(), k.to_local(), v.to_local()
    off = common.shard_offset(k, 1)
    mask = valid[off:off + kl.shape[1]][None, None, :]
    qg = _split_gqa(ql, kl.shape[2])
    if not seq and not dh:
        out = _attend(qg, kl, vl, mask, softcap_val)
    else:
        s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), kl.float())
        s = common.all_reduce(s, "sum", mesh, dh) * q.shape[-1] ** -0.5
        s = common.softcap(s, softcap_val)
        s = torch.where(mask[:, None, None, :, :], s, NEG_INF)
        m = common.all_reduce(s.amax(dim=-1, keepdim=True), "max", mesh,
                              seq)
        e = torch.exp(s - m)
        probs = e / common.all_reduce(e.sum(dim=-1, keepdim=True), "sum",
                                      mesh, seq)
        out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(vl.dtype).float(),
                           vl.float())
        out = common.all_reduce(out, "sum", mesh, seq).to(vl.dtype)
    out = _merge_gqa(out)
    return DTensor.from_local(out, mesh, place, run_check=False,
                              shape=q.shape,
                              stride=torch.empty(q.shape,
                                                 device="meta").stride())


def apply_attention_decode(p: dict, h_in: torch.Tensor, cache: dict,
                           pos: int, cfg: ModelConfig, *, window: int = 0,
                           policy: Policy = NO_POLICY):
    """One-token decode.  h_in: (B, 1, D); pos: the current index.

    Writes the token's K/V into ``cache`` in place and returns
    ``(out (B, 1, D), cache)``.  The cache is constrained to
    ``("batch", "kv_seq", "kv_heads", "head_dim")`` before the attention,
    as the reference's is -- except under a live token split, whose rules
    leave ``kv_heads`` unsharded where ``cache_specs`` shards the heads:
    there the attention runs on the cache as placed (each rank's kv heads,
    or its ``kv_seq`` rows), the batch gathered to the cache's split
    (``dp2d``) and the heads' output gathered after, never the cache.  Over a live model axis the cache is DTensors
    placed by ``sharding.cache_specs``: only the rank holding the new slot
    writes it (:func:`_write_slot`; a ring's slot moves from rank to rank
    as ``pos`` advances), and the attention runs on each rank's shards
    (:func:`_attend_sharded`); the ``wo`` product's ``Partial`` sum is left
    for the caller's constrain."""
    b = h_in.shape[0]
    if policy.token_split and common.is_dtensor(h_in):
        # dp2d splits the batch over model where the cache does not:
        # gathered (an all-reduce) to the cache's batch split
        h_in = common.batch_as(h_in, cache["k"])
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=h_in.device)
    q, k_new, v_new = _project_qkv(p, h_in, cfg, positions)

    size = cache["k"].shape[1]
    slot = pos % size if window else pos
    if slot >= size:
        raise ValueError(f"position {pos} beyond the global cache's {size} "
                         f"slots (size the cache by prompt + generated)")
    _write_slot(cache["k"], k_new, slot)
    _write_slot(cache["v"], v_new, slot)
    axes = ("batch", "kv_seq", "kv_heads", "head_dim")
    k, v = cache["k"], cache["v"]
    if not policy.token_split:
        k, v = policy.constrain(k, axes), policy.constrain(v, axes)

    idx = torch.arange(size, device=h_in.device)
    if window:
        # slot j holds the largest logical position p' <= pos with
        # p' % size == j
        logical = pos - torch.remainder(pos - idx, size)
        valid = (logical >= 0) & (logical <= pos) & (pos - logical < window)
    else:
        valid = idx <= pos
    if common.is_dtensor(k):
        out = _attend_sharded(q, k, v, valid, cfg.attn_logit_softcap)
        if common.sharding_dims(out, 2) and not common.sharding_dims(
                p["wo"], 0):
            # heads split by the cache, wo whole (a token split's
            # replicated weights): the heads' output gathered by an
            # all-reduce, then the unsharded product
            from torch.distributed.tensor import Replicate
            out = common.redistribute_by_sum(out, [
                Replicate() if pl.is_shard(2) else pl
                for pl in out.placements])
    else:
        out = _merge_gqa(_attend(_split_gqa(q, cfg.n_kv_heads), k, v,
                                 valid[None, None, :],
                                 cfg.attn_logit_softcap))
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(out.dtype))
    return out, cache
