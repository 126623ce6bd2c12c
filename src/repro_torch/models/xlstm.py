"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM (scalar).

The port of ``repro.models.xlstm``.  Neither block reaches a Pallas kernel
in the reference (it computes both with ``lax.scan`` and einsums), so both
are plain PyTorch here, in f32 where the reference widens; TF32 stays off.

mLSTM
-----
Matrix-memory cell with exponential input gate and sigmoid forget gate,
stabilized by the running max ``m``:

    m_t = max(logsig(f~_t) + m_{t-1}, i~_t)
    f'  = exp(logsig(f~_t) + m_{t-1} - m_t);  i' = exp(i~_t - m_t)
    C_t = f' C_{t-1} + i' v_t k_t^T;          n_t = f' n_{t-1} + i' k_t
    h_t = (C_t q_t) / max(|n_t . q_t|, exp(-m_t))

:func:`mlstm_recurrent` steps it (the oracle and the decode path);
:func:`mlstm_chunked` is the chunkwise-parallel form (training and
prefill): within a chunk an (L x L) masked product, across chunks the
state carried chunk by chunk, each chunk recomputed in the backward pass
(the reference's ``jax.checkpoint`` of its scan body).

sLSTM
-----
Scalar-memory cell with a per-head block-diagonal recurrence, sequential
in time.  :func:`slstm_block` runs it step by step under plain autograd:
the reference's custom VJP replays the same arithmetic to place SPMD
collectives, and one card has none.

Traps the port follows: ``log_sigmoid(x)`` is ``-logaddexp(-x, 0)``;
``swish(x)`` is ``x * sigmoid(x)``; ``k / sqrt(Dh)`` divides by sqrt(Dh)
rounded to k's dtype; m starts at -1e30 for the mLSTM and at 0 for the
sLSTM (n at 1e-6); ``_slstm_out`` casts the cell output to bf16 even in
an f32 config.

Over a live model axis the blocks take the reference's ``policy``: its
specs keep every mixer weight replicated, so training and prefill run
each block whole on each rank's rows of the batch (:func:`_on_rows`),
while the decode cache is split (the mLSTM's ``C`` over its value index,
``n`` over its key index, ``conv`` over its channels, and the sLSTM's
``n``), so each decode step computes on each rank's slices and gathers
what a whole head needs by all-reduces (:func:`_mlstm_decode_sharded`);
the sLSTM gathers its ``n`` and runs whole (:func:`_slstm_decode_sharded`).
Under ``dp2d`` the serve step first gathers the input's batch to the
cache's batch split (``common.batch_as``).

**On a rank's rows** (a ``seq2d`` / ``seq2d_fsdp`` token split,
``common.TokenSplit`` with ``dims``: the block runs on this rank's
positions) each block computes the unsplit function, the ranks one after
another, all-reduces only:

* the mLSTM (:func:`_mlstm_split`): the conv's halo, rank q - 1's last 3
  pre-conv rows (``common.split_tails``, one all-reduce), then the chunked
  scan from the (C, n, m) f32 state rank q - 1 hands on
  (``common.split_chain``: one all-reduce a hop), in chunks of the
  largest size that divides both a rank's rows and ``mlstm_chunk`` (where
  the rows are whole chunks, the unsplit run's arithmetic);
* the sLSTM (:func:`_slstm_split`): the step loop from the (c, n, h, m)
  f32 state rank q - 1 hands on, one all-reduce a hop.

The last hop gives every rank the last rank's state, which with the last
rank's conv rows is the decode cache, alike on every rank.  Under autograd
each hop's backward all-reduces the carry's gradient back to its owner, in
one order on every rank (``common.split_chain``).  Under ``dp2d``
(``TokenSplit`` without ``dims``) a rank holds whole sequences and the
blocks run as on one device.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.models.common import NO_POLICY, Policy
from repro_torch.models.mlp import gelu
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

_M0 = -1e30          # the mLSTM's initial running max
_SLSTM_STATE = ("c", "n", "h", "m")


def swish(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.swish``: ``x * sigmoid(x)`` in x's dtype."""
    return x * torch.sigmoid(x)


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)`` with softplus as
    ``logaddexp(., 0)``."""
    return -torch.logaddexp(-x, torch.zeros_like(x))


# ===========================================================================
# mLSTM
# ===========================================================================

def _mlstm_dims(cfg: ModelConfig):
    d_inner = int(cfg.d_model * cfg.mlstm_proj_factor)
    nh = cfg.n_heads
    return d_inner, nh, d_inner // nh


def init_mlstm(generator: torch.Generator, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di, nh, dh = _mlstm_dims(cfg)
    dt = cfg.torch_param_dtype()
    dev = generator.device
    return {
        "w_up": common.dense_init(generator, (d, di), dtype=dt),
        "w_gate": common.dense_init(generator, (d, di), dtype=dt),
        "conv": common.dense_init(generator, (4, di), fan_in=4, dtype=dt),
        # block-diagonal (per-head) q/k/v projections
        "wq": common.dense_init(generator, (nh, dh, dh), fan_in=dh, dtype=dt),
        "wk": common.dense_init(generator, (nh, dh, dh), fan_in=dh, dtype=dt),
        "wv": common.dense_init(generator, (nh, dh, dh), fan_in=dh, dtype=dt),
        "w_if": common.dense_init(generator, (di, 2 * nh), fan_in=di),
        "b_if": torch.cat([torch.zeros((nh,), device=dev),     # input gate
                           torch.full((nh,), 3.0, device=dev)]),  # forget +3
        "norm": common.init_rmsnorm(dh, dt, dev),
        "w_down": common.dense_init(generator, (di, d), fan_in=di, dtype=dt),
    }


def _causal_conv(w: torch.Tensor, x: torch.Tensor,
                 window: Optional[torch.Tensor]) -> torch.Tensor:
    """Depthwise causal conv of width ``w.shape[0]`` over (B, S, Di), the
    reference's sum of shifted products in x's dtype; ``window`` is the
    (B, tw - 1, Di) history or None for zeros."""
    tw, s = w.shape[0], x.shape[1]
    if window is None:
        pad = torch.zeros((x.shape[0], tw - 1, x.shape[-1]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = window.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = xp[:, 0:s] * w[0]
    for i in range(1, tw):
        out = out + xp[:, i:i + s] * w[i]
    return out


def _mlstm_heads(p: dict, x: torch.Tensor, xc: torch.Tensor,
                 cfg: ModelConfig):
    """(q, k, v, i_raw, log_f) from x and xc (B, S, Di): xc feeds q, k and
    the gates; v takes the raw up-projection."""
    di, nh, dh = _mlstm_dims(cfg)
    b, s, _ = x.shape
    xch = xc.reshape(b, s, nh, dh)
    xh = x.reshape(b, s, nh, dh)
    q = torch.einsum("bshd,hde->bshe", xch, p["wq"].to(x.dtype))
    k = torch.einsum("bshd,hde->bshe", xch, p["wk"].to(x.dtype))
    v = torch.einsum("bshd,hde->bshe", xh, p["wv"].to(x.dtype))
    # sqrt(Dh) rounded to k's dtype first, as the reference's
    # jnp.asarray(dh ** 0.5, k.dtype)
    k = k / torch.tensor(math.sqrt(dh), dtype=torch.float32,
                         device=k.device).to(k.dtype)
    gates = torch.matmul(xc.float(), p["w_if"]) + p["b_if"]
    i_raw, f_raw = gates[..., :nh], gates[..., nh:]          # (B, S, NH)
    return q, k, v, i_raw, log_sigmoid(f_raw)


def _mlstm_qkv_gates(p: dict, h_in: torch.Tensor, cfg: ModelConfig,
                     conv_window: Optional[torch.Tensor] = None):
    """Shared pre-computation.  h_in (B, S, D) -> (x, z, q, k, v, i_raw,
    log_f)."""
    x = torch.matmul(h_in, p["w_up"].to(h_in.dtype))
    z = torch.matmul(h_in, p["w_gate"].to(h_in.dtype))
    xc = swish(_causal_conv(p["conv"].to(x.dtype), x, conv_window))
    return (x, z) + _mlstm_heads(p, x, xc, cfg)


def _mlstm_out(p: dict, h_cell: torch.Tensor, z: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """h_cell: (B, S, NH, DH) -> (B, S, D)."""
    b, s, nh, dh = h_cell.shape
    h_cell = common.apply_rmsnorm(p["norm"], h_cell, cfg.norm_eps)
    h = h_cell.reshape(b, s, nh * dh) * swish(z)
    return torch.matmul(h, p["w_down"].to(h.dtype))


# -- recurrent oracle / decode ------------------------------------------------

def mlstm_cell_step(q, k, v, i_raw, log_f, state: dict):
    """One step.  q/k/v: (B, NH, DH); i_raw/log_f: (B, NH).

    state: dict(C (B, NH, DH, DH), n (B, NH, DH), m (B, NH)), all f32.
    Returns (h (B, NH, DH) f32, new state)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    m_new = torch.maximum(log_f + state["m"], i_raw)
    f_p = torch.exp(log_f + state["m"] - m_new)[..., None]
    i_p = torch.exp(i_raw - m_new)[..., None]
    C = f_p[..., None] * state["C"] + i_p[..., None] * (vf[..., :, None]
                                                        * kf[..., None, :])
    n = f_p * state["n"] + i_p * kf
    num = torch.matmul(C, qf[..., None])[..., 0]
    den = torch.maximum(torch.abs(torch.sum(n * qf, dim=-1)),
                        torch.exp(-m_new))[..., None]
    return num / den, {"C": C, "n": n, "m": m_new}


def _zero_state(b: int, nh: int, dh: int, device) -> dict:
    return {"C": torch.zeros((b, nh, dh, dh), device=device),
            "n": torch.zeros((b, nh, dh), device=device),
            "m": torch.full((b, nh), _M0, device=device)}


def init_mlstm_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    _, nh, dh = _mlstm_dims(cfg)
    return _zero_state(batch, nh, dh, device)


def mlstm_recurrent(q, k, v, i_raw, log_f, state: Optional[dict] = None):
    """Oracle: :func:`mlstm_cell_step` over S.  q/k/v: (B, S, NH, DH)."""
    b, s, nh, dh = q.shape
    if state is None:
        state = _zero_state(b, nh, dh, q.device)
    hs = []
    for t in range(s):
        h, state = mlstm_cell_step(q[:, t], k[:, t], v[:, t], i_raw[:, t],
                                   log_f[:, t], state)
        hs.append(h)
    return torch.stack(hs, dim=1), state


# -- chunkwise parallel form --------------------------------------------------

def _mlstm_chunk(C, n, m, qb, kb, vb, ib, fb, causal):
    """One chunk: qb/kb/vb (B, NH, L, DH) in their storage dtype, ib/fb
    (B, NH, L); state C (B, NH, DH, DH), n (B, NH, DH), m (B, NH).
    Returns (h (B, NH, L, DH) f32, C, n, m)."""
    qb, kb, vb = qb.float(), kb.float(), vb.float()
    bcum = torch.cumsum(fb, dim=-1)                  # inclusive logF cumsum
    btot = bcum[..., -1:]
    # intra-chunk log weights D[j, t] = bcum_j - bcum_t + i_t  (t <= j)
    dmat = bcum[..., :, None] - bcum[..., None, :] + ib[..., None, :]
    dmat = torch.where(causal, dmat, -math.inf)
    m_intra = torch.amax(dmat, dim=-1)               # (B, NH, L)
    m_inter = m[..., None] + bcum
    m_j = torch.maximum(m_inter, m_intra)
    # inter contribution: q against C's key (last) index
    w_inter = torch.exp(m_inter - m_j)
    h_inter = torch.matmul(qb, C.transpose(-1, -2)) * w_inter[..., None]
    n_inter = n[..., None, :] * w_inter[..., None]
    # intra contribution
    wmat = torch.exp(dmat - m_j[..., None])          # (B, NH, L, L)
    scores = torch.matmul(qb, kb.transpose(-1, -2)) * wmat
    h_intra = torch.matmul(scores, vb)
    n_intra = torch.matmul(wmat, kb)
    n_j = n_inter + n_intra
    den = torch.maximum(torch.abs(torch.sum(n_j * qb, dim=-1)),
                        torch.exp(-m_j))
    h = (h_inter + h_intra) / den[..., None]
    # chunk-end state
    m_endi = torch.amax(btot - bcum + ib, dim=-1)    # (B, NH)
    m_end = torch.maximum(m + btot[..., 0], m_endi)
    w_old = torch.exp(m + btot[..., 0] - m_end)
    w_new = torch.exp(btot - bcum + ib - m_end[..., None])    # (B, NH, L)
    # "bhl,bhld,bhle->bhde": (w v)^T k
    C = C * w_old[..., None, None] + torch.matmul(
        (w_new[..., None] * vb).transpose(-1, -2), kb)
    n = n * w_old[..., None] + torch.matmul(w_new[..., None, :], kb)[..., 0, :]
    return h, C, n, m_end


def mlstm_chunked(q, k, v, i_raw, log_f, chunk: int = 64,
                  state: Optional[dict] = None):
    """Chunkwise-parallel mLSTM.  q/k/v: (B, S, NH, DH) -> ((B, S, NH, DH)
    f32, state).  Equal to :func:`mlstm_recurrent` to f32 rounding.  Under
    autograd each chunk is recomputed in the backward pass, so only the
    chunk-boundary states are kept."""
    b, s, nh, dh = q.shape
    if s % chunk:
        raise ValueError(f"seq {s} % chunk {chunk} != 0")
    nc = s // chunk

    def rs(t):   # (B, S, NH, X) -> (NC, B, NH, L, X), in storage dtype
        return t.reshape(b, nc, chunk, nh, -1).permute(1, 0, 3, 2, 4)

    qc, kc, vc = rs(q), rs(k), rs(v)
    ic = i_raw.reshape(b, nc, chunk, nh).permute(1, 0, 3, 2)   # (NC,B,NH,L)
    fc = log_f.reshape(b, nc, chunk, nh).permute(1, 0, 3, 2)
    if state is None:
        state = _zero_state(b, nh, dh, q.device)
    C, n, m = state["C"], state["n"], state["m"]
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=q.device))
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v, i_raw, log_f, C, n, m))
    hs = []
    for c in range(nc):
        args = (C, n, m, qc[c], kc[c], vc[c], ic[c], fc[c], causal)
        if remat:
            h, C, n, m = checkpoint(_mlstm_chunk, *args, use_reentrant=False)
        else:
            h, C, n, m = _mlstm_chunk(*args)
        hs.append(h)
    h = torch.stack(hs).permute(1, 0, 3, 2, 4).reshape(b, s, nh, dh)
    return h, {"C": C, "n": n, "m": m}


def _apply_mlstm(p: dict, h_in: torch.Tensor, cfg: ModelConfig,
                policy: Policy, return_state: bool):
    x, z, q, k, v, i_raw, log_f = _mlstm_qkv_gates(p, h_in, cfg)
    q = policy.constrain(q, ("batch", "seq", None, "mlstm_dh"))
    k = policy.constrain(k, ("batch", "seq", None, "mlstm_dh"))
    v = policy.constrain(v, ("batch", "seq", None, "mlstm_dh"))
    h, state = mlstm_chunked(q, k, v, i_raw, log_f, chunk=cfg.mlstm_chunk)
    out = _mlstm_out(p, h.to(h_in.dtype), z, cfg)
    if not return_state:
        return out
    conv = x[:, -3:].to(cfg.torch_compute_dtype()).clone()
    return out, state["C"], state["n"], state["m"], conv


def apply_mlstm(p: dict, h_in: torch.Tensor, cfg: ModelConfig,
                policy: Policy = NO_POLICY, return_state: bool = False):
    """Training and prefill.  (B, S, D) -> (B, S, D); ``return_state``
    also returns the decode cache: the chunked form's final state and the
    last three steps of the PRE-conv x in the compute dtype.  q, k and v
    are constrained as the reference's are (``mlstm_dh`` resolves to no
    split).  Over a live model axis the block runs whole on each rank's
    rows of the batch (:func:`_on_rows`), and on a rank's rows of a split
    sequence from the ranks before it (:func:`_mlstm_split`)."""
    split = common.seq_split(policy)
    if split is not None:
        return _mlstm_split(p, h_in, cfg, split, return_state)

    def run(p_, x_):
        return _apply_mlstm(p_, x_, cfg, policy, return_state)
    out = _on_rows(run, p, h_in, 5 if return_state else 1)
    if not return_state:
        return out
    out, C, n, m, conv = out
    return out, {"C": C, "n": n, "m": m, "conv": conv}


def _mlstm_split(p: dict, h_in: torch.Tensor, cfg: ModelConfig,
                 split: common.TokenSplit, return_state: bool):
    """:func:`apply_mlstm` on this rank's rows of a split sequence (module
    docstring): the conv's halo from rank q - 1's last pre-conv rows, the
    chunked scan from the (C, n, m) state rank q - 1 hands on
    (``common.split_chain``, each hop one all-reduce), and the cache the
    last rank's state and conv rows, alike on every rank.  The scan's
    chunk is the largest that divides both a rank's rows and
    ``mlstm_chunk``: where the rows are whole ``mlstm_chunk`` chunks the
    chunks are the unsplit run's, and the chained run is its arithmetic;
    else it is the same function in shorter chunks, equal to f32
    rounding."""
    b, n, _ = h_in.shape
    chunk = math.gcd(n, cfg.mlstm_chunk)
    grad = _needs_grad(p, h_in)
    x = torch.matmul(h_in, p["w_up"].to(h_in.dtype))
    z = torch.matmul(h_in, p["w_gate"].to(h_in.dtype))
    tw = p["conv"].shape[0]
    q, r = common.split_rank(split, n)
    tails = common.split_tails(x, split, tw, grad)
    xc = swish(_causal_conv(p["conv"].to(x.dtype), x,
                            common.split_halo(tails, q, tw)))
    qh, kh, vh, i_raw, log_f = _mlstm_heads(p, x, xc, cfg)
    _, nh, dh = _mlstm_dims(cfg)

    def run(carry):
        h, st = mlstm_chunked(qh, kh, vh, i_raw, log_f, chunk=chunk,
                              state=None if carry is None
                              else _mlstm_unpack(carry, nh, dh))
        return h, torch.cat([st[key].reshape(b, -1)
                             for key in ("C", "n", "m")], dim=1)
    zeros = torch.zeros((b, nh * (dh * dh + dh + 1)), device=x.device)
    h, last = common.split_chain(run, split, n, zeros, grad, after=tails)
    out = _mlstm_out(p, h.to(h_in.dtype), z, cfg)
    if grad:
        out = common.Keep.apply(out, tails, last)
    if not return_state:
        return out
    cache = _mlstm_unpack(last, nh, dh)
    cache["conv"] = tails[:, (r - 1) * (tw - 1):].to(
        cfg.torch_compute_dtype())
    return out, {key: v.contiguous() for key, v in cache.items()}


def _mlstm_unpack(state: torch.Tensor, nh: int, dh: int) -> dict:
    """The (B, NH (DH DH + DH + 1)) f32 state a hop carries as C, n, m."""
    b = state.shape[0]
    C, n, m = torch.split(state, [nh * dh * dh, nh * dh, nh], dim=1)
    return {"C": C.reshape(b, nh, dh, dh), "n": n.reshape(b, nh, dh),
            "m": m.reshape(b, nh)}


def _needs_grad(p: dict, x: torch.Tensor) -> bool:
    """Whether autograd records a block's work on ``x`` with weights
    ``p`` (every rank alike)."""
    return torch.is_grad_enabled() and (x.requires_grad or any(
        w.requires_grad for w in tree_flatten(p)[0]))


def init_mlstm_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    di, _, _ = _mlstm_dims(cfg)
    st = init_mlstm_state(cfg, batch, device)
    st["conv"] = torch.zeros((batch, 3, di), dtype=cfg.torch_compute_dtype(),
                             device=device)
    return st


def apply_mlstm_decode(p: dict, h_in: torch.Tensor, cache: dict,
                       cfg: ModelConfig, policy: Policy = NO_POLICY
                       ) -> Tuple[torch.Tensor, dict]:
    """One step.  h_in: (B, 1, D) -> ((B, 1, D), cache), the cache updated
    in place.  Over a live model axis the cache is as
    ``sharding.cache_specs`` places it, and the step runs on each rank's
    shards (:func:`_mlstm_decode_sharded`)."""
    if common.is_dtensor(h_in):
        return _mlstm_decode_sharded(p, common.batch_as(h_in, cache["m"]),
                                     cache, cfg), cache
    conv = cache["conv"]
    x, z, q, k, v, i_raw, log_f = _mlstm_qkv_gates(p, h_in, cfg,
                                                   conv_window=conv)
    state = {key: cache[key] for key in ("C", "n", "m")}
    h, state = mlstm_cell_step(q[:, 0], k[:, 0], v[:, 0], i_raw[:, 0],
                               log_f[:, 0], state)
    out = _mlstm_out(p, h[:, None].to(h_in.dtype), z, cfg)
    conv.copy_(torch.cat([conv, x.to(conv.dtype)], dim=1)[:, 1:])
    for key in ("C", "n", "m"):
        cache[key].copy_(state[key])
    return out, cache


def _mlstm_decode_sharded(p: dict, h_in, cache: dict, cfg: ModelConfig):
    """:func:`apply_mlstm_decode` on DTensors: ``h_in`` replicated over
    model, the weights replicated, and the cache's ``conv`` over its
    channels, ``C`` over its value index and ``n`` over its key index
    (``cache_specs``; any of them may be whole).  Each rank convolves its
    channels, and the whole ``xc`` is gathered (an all-reduce) for q, k
    and the gates; it updates its value rows of ``C`` and its key slice of
    ``n``, so its ``C @ q`` is its slice of the numerator and its
    ``n . q`` a partial sum (an all-reduce); its slice of h is gathered
    (an all-reduce) for the head-wise norm.  ``m`` updates alike on every
    rank.  Each rank writes only its own shards, through their
    ``to_local()`` views.  Returns the (B, 1, D) output, placed as
    ``h_in``."""
    from torch.distributed.tensor import DTensor
    mesh = h_in.device_mesh
    di, _, dh = _mlstm_dims(cfg)
    w = _replicated(p)
    hl = h_in.to_local()
    conv, C, n = cache["conv"], cache["C"], cache["n"]
    conv_l, C_l, n_l, m_l = (_local(cache[key])
                             for key in ("conv", "C", "n", "m"))
    c0, v0, k0 = _offset(conv, 2), _offset(C, 2), _offset(n, 2)
    c1, v1, k1 = (c0 + conv_l.shape[2], v0 + C_l.shape[2],
                  k0 + n_l.shape[2])
    x = torch.matmul(hl, w["w_up"].to(hl.dtype))
    z = torch.matmul(hl, w["w_gate"].to(hl.dtype))
    xc = swish(_causal_conv(w["conv"][:, c0:c1].to(x.dtype),
                            x[..., c0:c1], conv_l))
    xc = common.gather_by_sum(xc, 2, c0, di, mesh,
                              common.sharding_dims(conv, 2))
    q, k, v, i_raw, log_f = _mlstm_heads(w, x, xc, cfg)
    # mlstm_cell_step on this rank's slices of C (value rows) and n (keys)
    qf, kf, vf = q[:, 0].float(), k[:, 0].float(), v[:, 0].float()
    m_new = torch.maximum(log_f[:, 0] + m_l, i_raw[:, 0])
    f_p = torch.exp(log_f[:, 0] + m_l - m_new)[..., None]
    i_p = torch.exp(i_raw[:, 0] - m_new)[..., None]
    C_new = f_p[..., None] * C_l + i_p[..., None] * (
        vf[..., v0:v1, None] * kf[..., None, :])
    n_new = f_p * n_l + i_p * kf[..., k0:k1]
    num = torch.matmul(C_new, qf[..., None])[..., 0]
    dot = common.all_reduce(torch.sum(n_new * qf[..., k0:k1], dim=-1),
                            "sum", mesh, common.sharding_dims(n, 2))
    den = torch.maximum(torch.abs(dot), torch.exp(-m_new))[..., None]
    h = common.gather_by_sum(num / den, 2, v0, dh, mesh,
                             common.sharding_dims(C, 2))
    out = _mlstm_out(w, h[:, None].to(hl.dtype), z, cfg)
    conv_l.copy_(torch.cat([conv_l, x[..., c0:c1].to(conv_l.dtype)],
                           dim=1)[:, 1:])
    C_l.copy_(C_new)
    n_l.copy_(n_new)
    m_l.copy_(m_new)
    return DTensor.from_local(out, mesh, h_in.placements, run_check=False,
                              shape=h_in.shape, stride=h_in.stride())


# -- a live model axis ---------------------------------------------------------

def _local(x: torch.Tensor) -> torch.Tensor:
    return x.to_local() if common.is_dtensor(x) else x


def _offset(x: torch.Tensor, dim: int) -> int:
    return common.shard_offset(x, dim) if common.is_dtensor(x) else 0


def _replicated(p: dict) -> dict:
    """The local tensors of a mixer's weights, which ``param_specs``
    replicates (the reference's SSM mixers stay replicated); another
    placement raises ``TypeError``."""
    def local(x):
        if common.is_dtensor(x) and not all(pl.is_replicate()
                                            for pl in x.placements):
            raise TypeError(f"an xLSTM weight {tuple(x.shape)} placed "
                            f"{x.placements}: the mixers' weights are "
                            f"replicated (param_specs)")
        return _local(x)
    return tree_map(local, p)


def _on_rows(fn, p: dict, x: torch.Tensor, n_out: int):
    """``fn(p, x)`` (``n_out`` outputs, each batch-major) on DTensors:
    the whole block on each rank's rows of the batch of ``x``, through one
    ``common.local_apply`` on local tensors.  The weights are replicated
    and ``x`` is replicated over model (sharded over data only on its
    batch), which is what GSPMD computes for the reference's replicated
    SSM mixers; the sLSTM's step loop stays on plain tensors.  The
    outputs are placed as ``x``.  A weight's gradient is computed whole on
    every model rank, so it leaves replicated there, and ``Partial`` over
    a mesh dim that shards the batch (each rank's rows add theirs).  On
    plain tensors it is ``fn(p, x)``: a token split's block (whole
    sequences under ``dp2d``; a split sequence takes :func:`_mlstm_split`
    or :func:`_slstm_split` instead)."""
    if not common.is_dtensor(x):
        return fn(p, x)
    from torch.distributed.tensor import Partial, Replicate
    place = list(x.placements)
    if any(not (pl.is_replicate() or pl.is_shard(0)) for pl in place):
        raise TypeError(f"an xLSTM block's input placed {x.placements}: "
                        f"replicated over model, its batch over data")
    leaves, treedef = tree_flatten(p)
    _replicated(p)
    grad = [Partial() if pl.is_shard() else Replicate() for pl in place]

    def local(xl, *ws):
        out = fn(tree_unflatten(treedef, list(ws)), xl)
        # DTensor.from_local reads a local tensor's strides as given
        return tuple(o.contiguous() for o in out) if n_out > 1 else out
    return common.local_apply(
        local, place if n_out == 1 else tuple([place] * n_out), x, *leaves,
        in_grad_placements=(None,) + (grad,) * len(leaves))


# ===========================================================================
# sLSTM
# ===========================================================================

def init_slstm(generator: torch.Generator, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    nh = cfg.n_heads
    dh = d // nh
    dff = int(d * cfg.slstm_ff_factor)
    dt = cfg.torch_param_dtype()
    dev = generator.device
    b = torch.zeros((4, d), device=dev)
    b[1] = 1.0                                       # forget bias +1
    return {
        # input projections for i, f, z, o stacked: (D, 4D)
        "w_x": common.dense_init(generator, (d, 4 * d), dtype=dt),
        # block-diagonal recurrent weights per gate: (4, NH, DH, DH)
        "r": common.dense_init(generator, (4, nh, dh, dh), fan_in=dh),
        "b": b,
        "norm": common.init_rmsnorm(dh, dt, dev),
        "ff_gate": common.dense_init(generator, (d, dff), dtype=dt),
        "ff_down": common.dense_init(generator, (dff, d), fan_in=dff,
                                     dtype=dt),
    }


def init_slstm_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    nh = cfg.n_heads
    dh = cfg.d_model // nh
    z = torch.zeros((batch, nh, dh), device=device)
    return {"c": z, "n": z + 1e-6, "h": z.clone(), "m": z.clone()}


def _slstm_gates(i_t, f_t, z_t, o_t, state: dict, zero) -> dict:
    """The step's gate math from its preactivations (any one layout for
    all of them and the state); ``zero`` is a 0-d zero for softplus."""
    log_f = -torch.logaddexp(-f_t, zero)           # log_sigmoid(f_t)
    lf_m = log_f + state["m"]
    m_new = torch.maximum(lf_m, i_t)
    i_p = torch.exp(i_t - m_new)
    f_p = torch.exp(lf_m - m_new)
    c = f_p * state["c"] + i_p * torch.tanh(z_t)
    n = f_p * state["n"] + i_p
    h = torch.sigmoid(o_t) * c / torch.clamp_min(n, 1e-6)
    return {"c": c, "n": n, "h": h, "m": m_new}


def slstm_cell_step(xg: torch.Tensor, r: torch.Tensor, state: dict) -> dict:
    """Single step, the oracle.  xg: (B, 4, NH, DH) preactivations, bias
    included; the recurrent contribution ``einsum("bhj,ghij->gbhi", h,
    r)`` with r indexed [gate, head, out, in]."""
    rec = torch.einsum("bhj,ghij->gbhi", state["h"], r)
    return _slstm_gates(*(xg[:, g] + rec[g] for g in range(4)), state,
                        torch.zeros((), device=xg.device))


def slstm_block(xg_b: torch.Tensor, r: torch.Tensor, state: dict):
    """sLSTM steps over a block.  xg_b: (B, T, 4, NH, DH) -> (hs (B, T, NH,
    DH), final state).  Plain autograd over the step loop: the gradients
    the reference's custom VJP (``_slstm_block_bwd``) computes.

    The loop runs head-major: the state as (NH, B, DH) and r laid out once
    as (NH, DH_in, 4 DH_out), so each step's recurrent contraction
    ``einsum("bhj,ghij->gbhi", h, r)`` is one batched product over the
    heads and the preactivations one add, with no copy of r a step."""
    b, t, _, nh, dh = xg_b.shape
    rt = r.permute(1, 3, 0, 2).reshape(nh, dh, 4 * dh)
    xs = xg_b.permute(1, 3, 0, 2, 4).contiguous()        # (T, NH, B, 4, DH)
    st = {k: v.transpose(0, 1) for k, v in state.items()}
    zero = torch.zeros((), dtype=xg_b.dtype, device=xg_b.device)
    hs = []
    for i in range(t):
        pre = xs[i] + torch.bmm(st["h"], rt).view(nh, b, 4, dh)
        st = _slstm_gates(*pre.unbind(2), st, zero)
        hs.append(st["h"])
    hs = torch.stack(hs).permute(2, 0, 1, 3)              # (B, T, NH, DH)
    return hs, {k: v.transpose(0, 1) for k, v in st.items()}


def _slstm_core(p: dict, h_in: torch.Tensor, cfg: ModelConfig,
                state: dict):
    """Sequential sLSTM over time: the input projection in f32 for every
    step at once, then :func:`slstm_block` over the whole sequence (the
    reference's blocks of 128 steps compute the same steps)."""
    return slstm_block(_slstm_inputs(p, h_in, cfg), p["r"], state)


def _slstm_inputs(p: dict, h_in: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """The (B, S, 4, NH, DH) f32 preactivations of every step, bias
    included."""
    b, s, d = h_in.shape
    nh = cfg.n_heads
    xg = torch.matmul(h_in.float(), p["w_x"].float())
    return (xg.reshape(b, s, 4, d) + p["b"][None, None]).reshape(
        b, s, 4, nh, d // nh)


def _slstm_out(p: dict, hs: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The cell output through the norm and the FFN (gelu between two
    products), in bf16 in every config: the reference casts ``hs`` to
    bf16 before the norm."""
    b, s, nh, dh = hs.shape
    hs = common.apply_rmsnorm(p["norm"], hs.to(torch.bfloat16), cfg.norm_eps)
    h = hs.reshape(b, s, nh * dh)
    g = torch.matmul(h, p["ff_gate"].to(h.dtype))
    return torch.matmul(gelu(g), p["ff_down"].to(h.dtype))


def apply_slstm(p: dict, h_in: torch.Tensor, cfg: ModelConfig,
                policy: Policy = NO_POLICY, return_state: bool = False):
    """Training and prefill.  (B, S, D) -> (B, S, D) in h_in's dtype;
    ``return_state`` also returns the final state (the decode cache).
    Over a live model axis the block runs whole on each rank's rows of the
    batch (:func:`_on_rows`), and on a rank's rows of a split sequence
    from the ranks before it (:func:`_slstm_split`)."""
    split = common.seq_split(policy)
    if split is not None:
        return _slstm_split(p, h_in, cfg, split, return_state)

    def run(p_, x_):
        state = init_slstm_state(cfg, x_.shape[0], x_.device)
        hs, state = _slstm_core(p_, x_, cfg, state)
        out = _slstm_out(p_, hs, cfg).to(x_.dtype)
        if not return_state:
            return out
        return (out,) + tuple(state[key] for key in _SLSTM_STATE)
    out = _on_rows(run, p, h_in, 5 if return_state else 1)
    if return_state:
        return out[0], dict(zip(_SLSTM_STATE, out[1:]))
    return out


def _slstm_split(p: dict, h_in: torch.Tensor, cfg: ModelConfig,
                 split: common.TokenSplit, return_state: bool):
    """:func:`apply_slstm` on this rank's rows of a split sequence: the
    step loop from the (c, n, h, m) state rank q - 1 hands on
    (``common.split_chain``, each hop one all-reduce of the stacked f32
    state), so the ranks' loops run one after another; the cache the last
    rank's state, alike on every rank."""
    b, n, d = h_in.shape
    nh = cfg.n_heads
    grad = _needs_grad(p, h_in)
    xg = _slstm_inputs(p, h_in, cfg)

    def run(carry):
        state = init_slstm_state(cfg, b, h_in.device) if carry is None \
            else _slstm_unpack(carry, nh)
        hs, st = slstm_block(xg, p["r"], state)
        return hs, torch.stack([st[key] for key in _SLSTM_STATE],
                               dim=1).reshape(b, -1)
    zeros = torch.zeros((b, 4 * d), device=h_in.device)
    hs, last = common.split_chain(run, split, n, zeros, grad, after=xg)
    out = _slstm_out(p, hs, cfg).to(h_in.dtype)
    if grad:
        out = common.Keep.apply(out, last)
    if not return_state:
        return out
    return out, {key: v.contiguous()
                 for key, v in _slstm_unpack(last, nh).items()}


def _slstm_unpack(state: torch.Tensor, nh: int) -> dict:
    """The (B, 4 D) f32 state a hop carries as c, n, h, m."""
    b = state.shape[0]
    return dict(zip(_SLSTM_STATE, state.reshape(b, 4, nh, -1).unbind(1)))


def init_slstm_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    return init_slstm_state(cfg, batch, device)


def apply_slstm_decode(p: dict, h_in: torch.Tensor, cache: dict,
                       cfg: ModelConfig, policy: Policy = NO_POLICY
                       ) -> Tuple[torch.Tensor, dict]:
    """One step (or several).  h_in: (B, T, D) -> ((B, T, D), cache), the
    cache updated in place.  Over a live model axis the cache's ``n`` is
    split over its last dim (``cache_specs``) and the steps run on it
    (:func:`_slstm_decode_sharded`)."""
    if common.is_dtensor(h_in):
        return _slstm_decode_sharded(p, common.batch_as(h_in, cache["c"]),
                                     cache, cfg), cache
    hs, state = _slstm_core(p, h_in, cfg, dict(cache))
    out = _slstm_out(p, hs, cfg).to(h_in.dtype)
    for key in _SLSTM_STATE:
        cache[key].copy_(state[key])
    return out, cache


def _slstm_decode_sharded(p: dict, h_in, cache: dict, cfg: ModelConfig):
    """:func:`apply_slstm_decode` on DTensors: ``h_in`` replicated over
    model, the weights replicated, ``c``, ``h`` and ``m`` whole on every
    rank and ``n`` split over its last dim where ``cache_specs`` splits it
    (the reference's name rule for the mLSTM's ``n`` catches the sLSTM's).
    ``n`` is gathered once (an all-reduce), then every rank runs the
    unsharded steps alike and writes back ``c``, ``h``, ``m`` and its own
    slice of ``n``, through their ``to_local()`` views.  Returns the
    (B, T, D) output, placed as ``h_in``."""
    from torch.distributed.tensor import DTensor
    mesh = h_in.device_mesh
    w = _replicated(p)
    hl = h_in.to_local()
    for key in ("c", "h", "m"):
        if common.sharding_dims(cache[key], 2):
            raise TypeError(f"the sLSTM's {key} placed "
                            f"{cache[key].placements}: only n is split")
    local = {key: _local(cache[key]) for key in _SLSTM_STATE}
    k0 = _offset(cache["n"], 2)
    k1 = k0 + local["n"].shape[2]
    n = common.gather_by_sum(local["n"], 2, k0, cfg.d_model // cfg.n_heads,
                             mesh, common.sharding_dims(cache["n"], 2))
    hs, st = _slstm_core(w, hl, cfg, dict(local, n=n))
    out = _slstm_out(w, hs, cfg).to(hl.dtype)
    st["n"] = st["n"][..., k0:k1]
    for key in _SLSTM_STATE:
        local[key].copy_(st[key])
    return DTensor.from_local(out, mesh, h_in.placements, run_check=False,
                              shape=h_in.shape, stride=h_in.stride())
