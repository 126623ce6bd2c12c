"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

The port of ``repro.models.rglru``.  Block layout:

    h -> W_in -> causal depthwise conv1d(width 4) -> RG-LRU -> * gelu(W_gate h) -> W_out

RG-LRU recurrence (diagonal, per channel):

    r_t = sigmoid(w_r * x_t + b_r)              recurrence gate
    i_t = sigmoid(w_i * x_t + b_i)              input gate
    log a_t = -c * softplus(lam) * r_t          c = 8
    y_t = a_t * y_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill runs the gates and the recurrence through
``kernels.rglru_scan.ops.lru_scan_gated`` (K6's gated entry on the card,
the gates then the sequential scan on the CPU) — the function the
reference's prefill gives its Pallas kernel on a TPU (``ops.lru_scan`` in
place of its associative scan, with the gates fused in front by XLA).
K6 has no backward, so training (:func:`apply_rglru_train`) runs
:func:`_gates` and :func:`linear_scan`, plain PyTorch under autograd,
with the reference's combine.  Decode is the single-step
recurrence carrying ``(y, conv window)`` state, updated in place.

Over a live model axis the ``rnn`` channels are sharded (``w_in``,
``w_gate`` column-parallel, ``w_out`` row-parallel, the conv and the gate
vectors by channel), the reference's constrains mark the input and the
output, and the conv and the recurrence, which are per channel, run on
each rank's channels through ``local_map`` (``common.local_apply``): K6's
gated entry in prefill, the plain scan in training, the one-step
recurrence in decode (on the cache's local channels, in place).  No
collective is needed inside the layer.

**On a rank's rows** (a ``seq2d`` / ``seq2d_fsdp`` token split,
``common.TokenSplit`` with ``dims``: the block runs on this rank's
positions, its weights whole) the layer computes the unsplit function
with two exchanges, all-reduces only (:func:`common.gather_by_sum`):

* the conv's halo, the tw - 1 pre-conv rows before the rank's first row:
  every rank's last tw - 1 rows gathered by one all-reduce
  (``common.split_tails``; ``common.GatherBySum`` in training, so the gradient
  flows back to the rows' owner), the first rank's halo zeros;
* the recurrence's carry, a (B, Dr) f32 state.  In prefill
  (:func:`_chain_scan`) rank q runs K6's gated entry on its rows from
  ``y0`` = rank q - 1's ``y_last`` (the kernel's f32 state after its last
  row: a bf16 y's last row is not the state), one all-reduce a hop, and
  the last hop hands every rank the last rank's state for the cache: the
  scan is serialised over the ranks, and the chained run is bitwise the
  whole-sequence run.  In training (:func:`_train_split`) each rank scans
  its rows from 0 (:func:`linear_scan`, which also gives the cumulative
  ``a``), every rank's ``(A_last, L_last)`` is gathered by one
  all-reduce, and rank q composes its incoming state from the ranks
  before it, ``y = L + A y_in``, differentiably.

The cache a rank's rows give back is whole (the last rank's state and
conv rows), for the serve step to place by ``cache_specs``.  Under
``dp2d`` (``TokenSplit`` without ``dims``) a rank holds whole sequences
and the layer runs as on one device.  The serve step's cache holds each
rank's ``rnn`` channels even where a token split replicates the weights:
the step takes its weights' and input's slices of those channels
(:func:`_cache_channels`), no collective.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rglru_scan import ops
from repro_torch.models import common
from repro_torch.models.common import NO_POLICY, Policy
from repro_torch.models.mlp import gelu

_C = 8.0


def init_rglru(generator: torch.Generator, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    dr = cfg.resolved_d_rnn
    tw = cfg.lru_temporal_width
    dt = cfg.torch_param_dtype()
    dev = generator.device
    # lam such that a^c spans ~(0.9, 0.999), as in the Griffin paper
    u = 0.9 + (0.999 - 0.9) * common.rand(generator, (dr,))
    lam = torch.log(torch.expm1(-torch.log(u) / _C))  # softplus^-1(-log u / c)
    return {
        "w_in": common.dense_init(generator, (d, dr), dtype=dt),
        "w_gate": common.dense_init(generator, (d, dr), dtype=dt),
        "w_out": common.dense_init(generator, (dr, d), fan_in=dr, dtype=dt),
        "conv": common.dense_init(generator, (tw, dr), fan_in=tw, dtype=dt),
        **{k: torch.zeros((dr,), dtype=torch.float32, device=dev)
           for k in ("w_r", "b_r", "w_i", "b_i")},
        "lam": lam,
    }


def _gates(p: dict, x: torch.Tensor):
    """(a, b) of the recurrence in f32.  Softplus is ``logaddexp(x, 0)``,
    as ``jax.nn.softplus`` (``F.softplus`` switches to ``x`` above 20)."""
    xf = x.float()
    r = torch.sigmoid(p["w_r"] * xf + p["b_r"])
    i = torch.sigmoid(p["w_i"] * xf + p["b_i"])
    lam = p["lam"]
    log_a = -_C * torch.logaddexp(lam, torch.zeros_like(lam)) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (i * xf)
    return a, b


def lru_scan(p: dict, x: torch.Tensor,
             y0: Optional[torch.Tensor] = None,
             y_last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The recurrence over (B, S, Dr) with its gates, through
    ``ops.lru_scan_gated`` (K6's gated entry on the card; on the CPU
    :func:`_gates`' arithmetic, then the sequential scan); y0 is folded
    into the first step, ``y_1 = a_1 y_0 + b_1``.  Returned in
    ``x.dtype``; ``y_last`` (B, Dr) f32, if given, receives the scan's f32
    state after the last step."""
    lam = p["lam"]
    c = -_C * torch.logaddexp(lam, torch.zeros_like(lam))
    return ops.lru_scan_gated(x, p["w_r"], p["b_r"], p["w_i"], p["b_i"], c,
                              None if y0 is None else y0.float(), y_last)


def linear_scan(a: torch.Tensor, b: torch.Tensor, with_a: bool = False):
    """``y_t = a_t * y_{t-1} + b_t`` along axis 1 from ``y_0 = 0``,
    differentiable: the reference's ``associative_scan`` combine
    ``(a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)`` in a log-depth doubling
    scan.  ceil(log2 S) steps of whole-tensor ops keep autograd's graph
    and the card's launches at 2 log2 S per layer, where the sequential
    loop would take S of each; the sums group differently from XLA's
    scan, so the two agree to f32 rounding, not bitwise.  ``with_a``:
    ``(y, A)``, ``A_t = a_1 ... a_t`` the cumulative product the scan
    builds (the state from ``y_0`` is then ``y + A y_0``)."""
    s = a.shape[1]
    d = 1
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return (b, a) if with_a else b


def _causal_conv(p: dict, x: torch.Tensor,
                 window: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv, width tw.  window: (B, tw-1, Dr) history."""
    w = p["conv"].to(x.dtype)                       # (tw, Dr)
    tw, s = w.shape[0], x.shape[1]
    if window is None:
        pad = torch.zeros((x.shape[0], tw - 1, x.shape[-1]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = window.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                 # (B, S + tw - 1, Dr)
    out = xp[:, 0:s] * w[0]
    for i in range(1, tw):
        out = out + xp[:, i:i + s] * w[i]
    return out


_CHANNEL_KEYS = ("conv", "w_r", "b_r", "w_i", "b_i", "lam")


def _per_channel(fn, p: dict, x: torch.Tensor):
    """``fn(x, p') -> y`` with ``p'`` the conv and gate leaves of ``p``, on
    each rank's channels when ``x`` is a DTensor (y placed as x)."""
    def local(x, *vals):
        return fn(x, dict(zip(_CHANNEL_KEYS, vals)))
    placements = list(x.placements) if common.is_dtensor(x) else None
    return common.local_apply(local, placements, x,
                              *(p[k] for k in _CHANNEL_KEYS))


def _prefill_core(x: torch.Tensor, p: dict) -> torch.Tensor:
    return lru_scan(p, _causal_conv(p, x))


def _train_core(x: torch.Tensor, p: dict) -> torch.Tensor:
    a, b = _gates(p, _causal_conv(p, x))
    return linear_scan(a, b).to(x.dtype)


# ---------------------------------------------------------------------------
# On a rank's rows (a token split of the sequence; module docstring)
# ---------------------------------------------------------------------------

def _chain_scan(p: dict, xc: torch.Tensor, split: common.TokenSplit):
    """K6's gated entry on this rank's conv output ``xc`` from the state
    rank q - 1 hands on, then this rank's state handed on
    (``common.split_chain``: hop j is one all-reduce of rank j's f32
    ``y_last``, which rank j + 1 takes as its ``y0``; the last hop gives
    every rank the last rank's state).  Returns ``(y, state)``: this
    rank's rows in ``xc``'s dtype, the last rank's (B, Dr) f32 state."""
    b, n, dr = xc.shape
    last = torch.zeros((b, dr), dtype=torch.float32, device=xc.device)

    def run(carry):
        return lru_scan(p, xc, carry, y_last=last), last
    return common.split_chain(run, split, n, torch.zeros_like(last))


def _train_split(p: dict, x: torch.Tensor, split: common.TokenSplit,
                 tw: int) -> torch.Tensor:
    """The training recurrence on this rank's rows (module docstring):
    the halo'd conv, the scan from 0 with its cumulative ``a``, every
    rank's ``(A_last, L_last)`` gathered, and the incoming state composed
    from the ranks before this one."""
    q, r = common.split_rank(split, x.shape[1])
    tails = common.split_tails(x, split, tw, grad=True)
    a, b = _gates(p, _causal_conv(p, x,
                                  window=common.split_halo(tails, q, tw)))
    y, cum = linear_scan(a, b, with_a=True)
    ends = torch.stack([cum[:, -1], y[:, -1]], dim=1)       # (B, 2, Dr)
    ends = common.GatherBySum.apply(ends, 1, 2 * q, 2 * r, split.mesh,
                                    split.dims, split.dims)
    if q:
        y_in = ends[:, 1]
        for j in range(1, q):
            y_in = ends[:, 2 * j + 1] + ends[:, 2 * j] * y_in
        y = y + cum * y_in[:, None]
    return common.Keep.apply(y, tails, ends).to(x.dtype)


def apply_rglru(p: dict, h_in: torch.Tensor, cfg: ModelConfig,
                return_state: bool = False, policy: Policy = NO_POLICY):
    """Prefill path.  h_in: (B, S, D) -> (B, S, D).

    ``return_state=True`` also returns the decode cache: the last step's
    ``y`` in f32 (rounded through ``x.dtype`` first, as the reference's
    is) and the last tw - 1 steps of the pre-conv input.  On a rank's
    rows of a split sequence the conv takes its halo and the scan its
    carry from the ranks before (module docstring), and the cache is the
    whole sequence's."""
    x = torch.matmul(h_in, p["w_in"].to(h_in.dtype))
    x = policy.constrain(x, ("batch", "seq", "rnn"))
    g = torch.matmul(h_in, p["w_gate"].to(h_in.dtype))
    tw = cfg.lru_temporal_width
    split = common.seq_split(policy)
    if split is not None:
        q, r = common.split_rank(split, x.shape[1])
        tails = common.split_tails(x, split, tw, grad=False)
        y, last = _chain_scan(p, _causal_conv(p, x, window=common.split_halo(
            tails, q, tw)), split)
        state = {"y": last.to(x.dtype).float(),
                 "conv": tails[:, (r - 1) * (tw - 1):].to(
                     cfg.torch_compute_dtype())}
    else:
        y = _per_channel(_prefill_core, p, x)
        state = None
    out = policy.constrain(y * gelu(g), ("batch", "seq", "rnn"))
    out = torch.matmul(out, p["w_out"].to(h_in.dtype))
    if return_state:
        if state is None:
            state = {"y": y[:, -1].float().clone(),
                     "conv": x[:, -(tw - 1):].to(cfg.torch_compute_dtype()
                                                 ).clone()}
        return out, state
    return out


def apply_rglru_train(p: dict, h_in: torch.Tensor, cfg: ModelConfig,
                      policy: Policy = NO_POLICY) -> torch.Tensor:
    """Training path.  h_in: (B, S, D) -> (B, S, D), differentiable: the
    recurrence through :func:`linear_scan`, never K6; on a rank's rows of
    a split sequence with the halo and the composed carry
    (:func:`_train_split`)."""
    x = torch.matmul(h_in, p["w_in"].to(h_in.dtype))
    x = policy.constrain(x, ("batch", "seq", "rnn"))
    g = torch.matmul(h_in, p["w_gate"].to(h_in.dtype))
    split = common.seq_split(policy)
    if split is not None:
        y = _train_split(p, x, split, cfg.lru_temporal_width)
    else:
        y = _per_channel(_train_core, p, x)
    out = policy.constrain(y * gelu(g), ("batch", "seq", "rnn"))
    return torch.matmul(out, p["w_out"].to(h_in.dtype))


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_rglru_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    dr = cfg.resolved_d_rnn
    tw = cfg.lru_temporal_width
    return {"y": torch.zeros((batch, dr), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, tw - 1, dr),
                                dtype=cfg.torch_compute_dtype(),
                                device=device)}


def _decode_core(x: torch.Tensor, conv: torch.Tensor, y0: torch.Tensor,
                 p: dict) -> torch.Tensor:
    """One step of the conv and the recurrence, per channel: x (B, 1, Dr)
    against the window ``conv`` (B, tw-1, Dr) and state ``y0`` (B, Dr),
    both updated in place; returns y (B, 1, Dr) in f32."""
    xc = _causal_conv(p, x, window=conv)            # (B, 1, Dr)
    a, b = _gates(p, xc[:, 0])
    y = a * y0 + b                                  # (B, Dr) f32
    conv.copy_(torch.cat([conv, x.to(conv.dtype)], dim=1)[:, 1:])
    y0.copy_(y)
    return y[:, None]


def _cache_channels(h_in, p: dict, y) -> Tuple[torch.Tensor, dict]:
    """A token split's decode input and weights cut to the cache's
    placement (``cache_specs``: its ``rnn`` channels over model, its
    batch over the data axes), where a token split holds them whole: the
    input's batch gathered where ``dp2d`` splits it over model and the
    cache does not (an all-reduce), and each channel-dim weight's slice of
    the channels the cache's ``y`` holds on this rank (no collective), so
    the step runs on each rank's channels as over a tensor-parallel
    layout."""
    from torch.distributed.tensor import Shard
    h_in = common.batch_as(h_in, y)
    cdims = common.sharding_dims(y, 1)

    def cut(w, dim):
        if not common.is_dtensor(w) or common.sharding_dims(w, dim):
            return w
        return common.redistribute_by_sum(w, [
            Shard(dim) if i in cdims else pl
            for i, pl in enumerate(w.placements)])
    dims = {"w_in": 1, "w_gate": 1, "w_out": 0, "conv": 1,
            **{k: 0 for k in _CHANNEL_KEYS if k != "conv"}}
    return h_in, dict(p, **{k: cut(p[k], d) for k, d in dims.items()})


def apply_rglru_decode(p: dict, h_in: torch.Tensor, cache: dict,
                       cfg: ModelConfig, policy: Policy = NO_POLICY
                       ) -> Tuple[torch.Tensor, dict]:
    """One step.  h_in: (B, 1, D) -> ((B, 1, D), cache), the cache updated
    in place.  Over a live model axis the cache's ``y`` and ``conv`` hold
    each rank's ``rnn`` channels (``sharding.cache_specs``) and the step
    runs on them (:func:`_decode_core` through ``local_map``, writing the
    local shards); ``w_out``'s ``Partial`` sum is left for the caller's
    constrain.  The reference's decode constrains nothing here.  Under a
    live token split the step takes the slices of the cache's channels
    (:func:`_cache_channels`)."""
    if policy.token_split and common.is_dtensor(h_in):
        h_in, p = _cache_channels(h_in, p, cache["y"])
    x = torch.matmul(h_in, p["w_in"].to(h_in.dtype))
    g = torch.matmul(h_in, p["w_gate"].to(h_in.dtype))

    def core(x, conv, y0, *vals):
        return _decode_core(x, conv, y0, dict(zip(_CHANNEL_KEYS, vals)))
    placements = list(x.placements) if common.is_dtensor(x) else None
    y = common.local_apply(core, placements, x, cache["conv"], cache["y"],
                           *(p[k] for k in _CHANNEL_KEYS))
    out = y.to(h_in.dtype) * gelu(g)
    out = torch.matmul(out, p["w_out"].to(out.dtype))
    return out, cache
