"""Federated runtime: local client training, server state, the sync round.

The port of ``repro.core.federated``'s engine on both fold engines (flat,
and tree: one K4 launch over every leaf), every wire format, SCAFFOLD,
uniform cohort sampling and async rounds, for the paper's three
algorithms over any adapter:

* ``fedhen``   — Alg. 1 + Alg. 2 (side objective on complex devices)
* ``noside``   — Alg. 4 (same server step, no side objective)
* ``decouple`` — Alg. 3 (two independent FedAvg runs)

Local training (Alg. 2): E epochs of minibatch SGD, eta, global-norm clip
10, per-device NaN exclusion (Appendix A).

**Streaming contract** (the reference's).  Each population (simple, then
complex) is split into chunks of ``FedConfig.cohort_chunk`` clients (0 =
the whole population).  The reference vmaps its client trainer over a
chunk inside one jit; here a Python loop trains the chunk's clients one
after another and writes each trained client straight into row ``z`` of a
preallocated ``(chunk, n_flat)`` buffer, so the fold stays ONE kernel
launch per chunk (two for decouple).  A population the chunk does not
divide is padded with weight-0 slots; those slots are not trained (their
row is gated out by the weight), count neither in the loss mean nor in
``n_valid``, and so cannot change the round.  Under uniform sampling
(``FedConfig.sample_uniform``) the plan's unfilled slots are treated the
same way, and the loss mean divides by the realised client count.

**SCAFFOLD** (``variance_reduction="scaffold"``, option II).  Each client
adds its correction ``c - c_i`` (zero outside M for simple clients) to
every minibatch gradient before the clip; after training its delta
``dc = (x - y) / (K lr) - c`` folds into the state's ``cv_acc`` through
one more K1 launch, and its row ``c_i + dc`` goes back to the
``FlatStateStore`` (a NaN client keeps its row; only real slots are
written).  The server control variate moves by ``cv_acc / n_devices``.

**Async rounds** (``FedConfig.async_lag > 0``).  ``run_round`` delegates
to ``core/async_rounds.AsyncRoundEngine``: chunk ``t`` trains on the
server version published ``ceil((lag - t) / F)`` rounds ago and folds at
the staleness weight ``1 / (1 + s)^a`` times its validity, through the
same :func:`stream_population` and the same folds.

**Telemetry** (``repro_torch.obs``, the reference's event stream).  A
trainer built with ``telemetry=`` emits a ``run_config`` ledger, and each
round a ``round`` span (``engine="sync"``, or ``"async"`` with its lag)
holding ``sample_gather``, ``execute`` (:class:`RoundDispatch`: on the
card, the first round loads the kernel library under a ``compile`` span,
and ``execute`` ends in ``torch.cuda.synchronize()``), the logical phase
spans of :func:`emit_round_phases`, the client-health counters and the
comm / client-state / store ledgers; ``run`` adds the ``eval`` ledger and
the ``log`` line.  ``execute`` covers what the reference's one jitted
round covers (broadcast through finalize); the store scatters, the
client-state record and the server's publication follow it, as in the
reference.  The first round runs under the roofline walk
(``roofline/torch_walk.py``, the counterpart of the reference's walk of its
compiled HLO) and emits one ``roofline`` ledger (``flops``, ``hbm_bytes``,
``collective_bytes``) before its ``execute`` span ends.  Off (the default,
:data:`obslib.NOOP`), no event is built and nothing is synchronized.

**Minibatch order.**  The reference draws each epoch's permutation from
threefry keys that PyTorch cannot reproduce, so the client trainer takes
its index schedule from a provider: ``schedule(round, population, slot,
epoch, n) -> permutation of range(n)``.  :class:`SeededSchedule` (the
default) seeds a ``torch.Generator`` per ``(seed, round, population, slot,
epoch)``, which keeps a round independent of how its cohort is chunked;
tests fill the provider with the reference's own permutations.

**The wire** (``core/comm.py``).  Clients train on the decoded broadcast.
Dense uploads stream through the fold in the wire's format (bf16 through
K1, int8 through K2).  Under wire v2 (``WireSpec.uses_deltas``) each client
uploads the encoded delta ``d = y - x`` against the broadcast it trained
on, plus its error-feedback row when EF is on, top-k and/or stochastically
rounded; the fold adds the broadcast once at the summed weights and each
encoded delta at its own (K1 + K3 for top-k).  Stochastic-rounding bits
come from a second provider, ``bits(round, population, slot, shape)``
(:class:`SeededBits` by default), for the same reason as the schedule.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import FedConfig
from repro_torch.core import (aggregate, client_state, comm, flatten, masking,
                              sampling, state_store)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import build
from repro_torch.obs import telemetry as obslib
from repro_torch.optim.sgd import sgd_update
from repro_torch.tree import Tree, tree_flatten, tree_leaves, tree_map, \
    tree_unflatten

Batch = Dict[str, torch.Tensor]
Schedule = Callable[[int, str, int, int, int], Sequence[int]]
# bits(round, population, slot, shape) -> int64 tensor of uint32 values
BitsProvider = Callable[[int, str, int, Tuple[int, ...]], torch.Tensor]

POPULATIONS = ("simple", "complex")

# the reference's fold_in tag for a client's wire-encode key ("WIRE"); here
# it separates the default bit stream from the minibatch order
_WIRE_TAG = 0x57495245


def _generator(*words: int) -> torch.Generator:
    """A CPU ``torch.Generator`` seeded from a SeedSequence of ``words``."""
    state = np.random.SeedSequence(list(words)).generate_state(2, np.uint32)
    seed = ((int(state[0]) << 32) | int(state[1])) & ((1 << 63) - 1)
    return torch.Generator().manual_seed(seed)


class SeededSchedule:
    """Default minibatch-order provider: ``torch.randperm`` from a CPU
    ``torch.Generator`` seeded by ``(seed, round, population, slot,
    epoch)`` — the same permutations on every device and chunking."""

    def __init__(self, seed: int):
        self.seed = int(seed)

    def __call__(self, round_index: int, population: str, slot: int,
                 epoch: int, n: int) -> torch.Tensor:
        g = _generator(self.seed & sampling._SEED_MASK, round_index,
                       POPULATIONS.index(population), slot, epoch)
        return torch.randperm(n, generator=g)


class SeededBits:
    """Default stochastic-rounding bit provider: uint32 values (in an
    int64 CPU tensor of ``shape``) from a CPU ``torch.Generator`` seeded by
    ``(seed, round, population, slot)`` — one upload per client per
    round, the same bits on every device and chunking."""

    def __init__(self, seed: int):
        self.seed = int(seed)

    def __call__(self, round_index: int, population: str, slot: int,
                 shape: Tuple[int, ...]) -> torch.Tensor:
        g = _generator(self.seed & sampling._SEED_MASK, round_index,
                       POPULATIONS.index(population), slot, _WIRE_TAG)
        return torch.randint(0, 2**32, tuple(shape), dtype=torch.int64,
                             generator=g)


# ---------------------------------------------------------------------------
# Local client optimization (Alg. 2)
# ---------------------------------------------------------------------------

def make_client_trainer(loss_fn: Callable[[Tree, Batch], torch.Tensor],
                        fed: FedConfig, *,
                        cv_layout: Optional[flatten.FlatLayout] = None):
    """Returns ``train(params, data, perms[, corr_flat]) -> (params',
    mean_loss)``.

    ``data``: dict of tensors with leading dim N_i (the client's local
    dataset).  ``perms``: one permutation of ``range(N_i)`` per epoch; each
    epoch takes ``steps = max(N_i // batch_size, 1)`` minibatches from the
    front of its permutation.  ``params`` is never modified; the returned
    tree is new (a leaf the loss never touches is returned as is).
    ``mean_loss`` is a 0-d tensor on the data's device.

    ``cv_layout`` (SCAFFOLD): ``train`` then takes the client's packed
    correction ``corr_flat = c - c_i`` (``(n_flat,)`` f32, already zeroed
    outside the population's slice), unpacks it once and adds it to every
    minibatch gradient before the clipped update.  A gradient PyTorch
    leaves as ``None`` (a leaf the loss does not touch, where JAX returns
    zeros) becomes the correction itself, so the clip counts it as the
    reference's does (``sgd_update``'s ``extra``).
    """

    def full_loss(p, anchor, batch):
        loss = loss_fn(p, batch)
        if fed.prox_mu:
            sq = sum(torch.sum(torch.square(a.float() - b.float()))
                     for a, b in zip(tree_leaves(p), tree_leaves(anchor)))
            loss = loss + 0.5 * fed.prox_mu * sq
        return loss

    def train(params: Tree, data: Batch, perms: Sequence,
              corr_flat: Optional[torch.Tensor] = None
              ) -> Tuple[Tree, torch.Tensor]:
        corr = None
        if cv_layout is not None and corr_flat is not None:
            corr = tree_leaves(flatten.unpack(cv_layout, corr_flat,
                                              cast=False))
        n = tree_leaves(data)[0].shape[0]
        steps = max(n // fed.batch_size, 1)
        device = tree_leaves(data)[0].device
        p = tree_map(lambda x: x.detach(), params)
        losses = []
        for perm in perms:
            idxs = torch.as_tensor(perm)[:steps * fed.batch_size]
            idxs = idxs.reshape(steps, fed.batch_size).to(device)
            for idx in idxs:
                batch = {k: v.index_select(0, idx) for k, v in data.items()}
                leaves, treedef = tree_flatten(p)
                for leaf in leaves:
                    leaf.requires_grad_(True)
                loss = full_loss(p, params, batch)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
                extra = None
                if corr is not None:
                    extra = tree_unflatten(treedef, [
                        c if g is None else None
                        for g, c in zip(grads, corr)])
                    grads = [None if g is None else g + c.to(g.dtype)
                             for g, c in zip(grads, corr)]
                with torch.no_grad():
                    p = sgd_update(tree_map(lambda x: x.detach(), p),
                                   tree_unflatten(treedef, grads), fed.lr,
                                   fed.clip_norm, extra)
                losses.append(loss.detach())
        return (tree_map(lambda x: x.detach(), p),
                torch.stack(losses).mean())

    return train


def local_step_count(data: Batch, fed: FedConfig) -> int:
    """SGD steps one client runs on its dataset ``data``:
    ``max(N_i // batch_size, 1) * local_epochs`` — the K of SCAFFOLD's
    ``(x - y) / (K lr)``."""
    n = tree_leaves(data)[0].shape[0]
    return max(n // fed.batch_size, 1) * fed.local_epochs


class ScaffoldCtx(NamedTuple):
    """One population's SCAFFOLD context (``variance_reduction=
    "scaffold"``).

    ``rows``: the cohort's gathered ``(k, n_flat)`` control variates
    ``c_i`` (a copy, updated in place to ``c_i + dc`` as clients train).
    ``c_global``: the server's ``(n_flat,)`` ``c``.  ``pop_mask``: the flat
    bool mask of the slice the population trains (M for simple clients,
    whose correction and delta live on M alone); ``None`` = every element.
    ``inv_k_lr``: ``1 / (K lr)`` of the population's step count."""
    rows: torch.Tensor
    c_global: torch.Tensor
    pop_mask: Optional[torch.Tensor]
    inv_k_lr: float


def _mask_pop(sc: ScaffoldCtx, v: torch.Tensor) -> torch.Tensor:
    """Zero an ``(n_flat,)`` cv vector outside the population's slice."""
    return v if sc.pop_mask is None else torch.where(sc.pop_mask, v, 0.0)


def _scaffold_delta(sc: ScaffoldCtx, x_flat: torch.Tensor,
                    y_flat: torch.Tensor, out: torch.Tensor) -> None:
    """``out = mask_pop((x - y) * inv_k_lr - c)`` for one client.

    Inside its jitted round XLA fuses the multiply and the subtract into
    one FMA; computing ``(x - y) * inv - c`` in f64 and rounding once to
    f32 gives the same f32 result (the f32 product is exact in f64)."""
    inv = float(np.float32(sc.inv_k_lr))
    d = (x_flat - y_flat).to(torch.float64)
    out.copy_(_mask_pop(sc, (d * inv - sc.c_global.to(torch.float64)
                             ).to(torch.float32)))


# ---------------------------------------------------------------------------
# The chunk stream
# ---------------------------------------------------------------------------

def chunk_geometry(k: int, cohort_chunk: int) -> Tuple[int, int]:
    """(chunk, n_chunks) of one population: ``chunk <= k``, the population
    padded up to a chunk multiple with weight-0 slots."""
    chunk = k if cohort_chunk <= 0 else min(cohort_chunk, k)
    return chunk, -(-k // chunk)


class WireUploadCtx(NamedTuple):
    """One population's wire-v2 upload context (active iff
    ``WireSpec.uses_deltas``).

    ``spec``: the round's wire.  ``k_top``: the population's top-k payload
    length, ``comm.topk_count`` of its TRUE element count (a simple
    client's delta is zero outside M, so its budget is |M|).  ``ef_rows``:
    the cohort's gathered ``(k, n_flat)`` error-feedback residuals, or
    ``None`` without EF.  ``bits``: the stochastic-rounding provider."""
    spec: comm.WireSpec
    k_top: int
    ef_rows: Optional[torch.Tensor]
    bits: BitsProvider


def _encode_upload(up: WireUploadCtx, d: torch.Tensor, bits):
    """Encode one client's delta ``d`` (``(n_flat,)`` f32): a
    :class:`comm.SparseWireBuffer` under top-k, else a
    :class:`comm.WireBuffer`."""
    if up.spec.is_sparse:
        return comm.sparse_encode(up.spec, d, up.k_top, bits=bits)
    return comm.encode(up.spec, d, bits=bits)


def _residual(up: WireUploadCtx, d: torch.Tensor, buf) -> torch.Tensor:
    """``d - decode(buf)``: what the encode dropped (the new EF row)."""
    if up.spec.is_sparse:
        dec = comm.sparse_decode_values(up.spec, buf)
        return d.clone().index_add_(0, buf.indices.to(torch.int64), -dec)
    return d - comm.decode(up.spec, buf)


def _fold_deltas(state, xz, x_flat, up: WireUploadCtx, ef_rows, slots,
                 valid, weights, is_simple, flat_mask, fed: FedConfig,
                 population: str, round_index: int, cv_chunk=None):
    """Encode one chunk's uploads as deltas and fold them (and a SCAFFOLD
    ``cv_chunk`` beside them).

    ``xz`` (Z, n_flat) f32 holds the trained clients and is overwritten
    with their deltas ``y - x`` (+ their EF rows), ``x_flat`` being the
    packed broadcast the chunk trained on; ``slots[z]`` is the population
    slot of row ``z`` (``None`` for an untrained slot, which uploads an
    encoded zero at weight 0).  ``valid`` (Z,) bool picks the EF rows;
    ``weights`` (``valid`` itself, or its staleness-weighted f32) weighs
    the fold.  Returns ``(state,
    new_ef_rows)`` — one row per chunk row: the residual ``(d + r) -
    decode(encode(d + r))`` of a trained client, its old row for a client
    with ``valid`` 0 and for an untrained slot; ``None`` without EF."""
    spec = up.spec
    d = xz.sub_(x_flat[None])
    if ef_rows is not None:
        d.add_(ef_rows)
    bufs = []
    for z, slot in enumerate(slots):
        if slot is None:
            bufs.append(_encode_upload(up, torch.zeros_like(d[z]), None))
            continue
        bits = (functools.partial(up.bits, round_index, population, slot)
                if spec.stochastic else None)
        bufs.append(_encode_upload(up, d[z], bits))
    stack = lambda xs: None if xs[0] is None else torch.stack(xs)
    sp = aggregate.SparseChunk(
        x_flat, stack([b.payload for b in bufs]),
        stack([b.scales for b in bufs]),
        stack([b.indices for b in bufs]) if spec.is_sparse else None)
    state = aggregate.streaming_fold_deltas(
        state, sp, flat_mask, is_simple, weights, fed.algorithm,
        quant_block=spec.quant_block, cv_chunk=cv_chunk)
    if ef_rows is None:
        return state, None
    new_rows = [ef_rows[z] if slot is None else
                torch.where(valid[z], _residual(up, d[z], bufs[z]),
                            ef_rows[z])
                for z, slot in enumerate(slots)]
    return state, new_rows


def stream_population(state, get_src: Callable[[Optional[int]], Tree],
                      train_fn, clients: List[Batch], *,
                      population: str, round_index: int, schedule: Schedule,
                      fed: FedConfig, layout: flatten.FlatLayout,
                      flat_mask: torch.Tensor, buffer: torch.Tensor,
                      chunk: int, n_chunks: int, wire: comm.WireSpec,
                      upload: Optional[WireUploadCtx] = None,
                      real: Optional[np.ndarray] = None,
                      scaffold: Optional[ScaffoldCtx] = None,
                      cv_buffer: Optional[torch.Tensor] = None,
                      leaf_masks: Optional[Tree] = None,
                      version_idx: Optional[Sequence[int]] = None,
                      staleness_w: Optional[torch.Tensor] = None):
    """Train one population chunk by chunk and fold each chunk into the
    running sums: the ONE chunk stream of both engines (the synchronous
    round and :class:`~repro_torch.core.async_rounds.AsyncRoundEngine`).

    ``clients`` are the population's ``k`` sampled datasets in slot order;
    chunk ``t``'s slots train from ``get_src(idx)`` (a decoded broadcast)
    on ``clients[i]`` with the schedule's permutations for ``(round_index,
    population, i, epoch)``.  The async extras: ``version_idx`` (one int a
    chunk, handed to ``get_src``) and ``staleness_w`` (``(n_chunks,)`` f32
    on the buffer's device, multiplied into the chunk's validity as the
    fold weight).  Without them ``idx`` is ``None`` and the fold weight is
    the bool validity: the synchronous program.  The wire-v2 and SCAFFOLD
    deltas are taken against the broadcast the chunk trained on, packed
    once a version.  Each trained client is packed into row ``z``
    of ``buffer[:chunk]`` (zero-padded once at allocation, in the fold's
    stream dtype); a client whose result is not all finite gets validity 0
    (when ``skip_nan_devices``).  ``real`` (uniform sampling): the plan's
    ``(k,)`` slot mask — an unfilled slot is not trained and folds at
    weight 0, like chunk padding.

    The fold: with ``leaf_masks`` (the tree engine) one K4 launch over
    every leaf (:func:`aggregate.tree_streaming_fold`); otherwise the flat
    fold, dense uploads in the ``wire``'s format, or with ``upload`` (wire
    v2) encoded deltas (:func:`_fold_deltas`).  With ``scaffold`` each
    client trains with its correction, and its delta ``dc`` goes to row
    ``z`` of ``cv_buffer`` and folds into the state's ``cv_acc``.

    Returns ``(state, mean_loss, n_valid, cv_rows, ef_rows)`` — 0-d
    tensors; the mean loss is normalized by the count of real slots;
    ``cv_rows`` / ``ef_rows`` are the ``(k, n_flat)`` updated control
    variates and EF residuals (``None`` when off; an untrained slot or a
    NaN client keeps its old row)."""
    k = len(clients)
    device = buffer.device
    xz = buffer[:chunk]
    cvz = cv_buffer[:chunk] if scaffold is not None else None
    is_simple = torch.full((chunk,), population == "simple",
                           dtype=torch.bool, device=device)
    in_plan = np.ones((k,), bool) if real is None else np.asarray(real, bool)
    loss_sum = torch.zeros((), device=device)
    valid_sum = torch.zeros((), device=device)
    needs_x = upload is not None or scaffold is not None
    x_flat = x_idx = None
    ef_in = upload.ef_rows if upload is not None else None
    ef_out = [] if ef_in is not None else None
    for t in range(n_chunks):
        idx = None if version_idx is None else int(version_idx[t])
        src = get_src(idx)
        if needs_x and (x_flat is None or idx != x_idx):
            x_flat, x_idx = flatten.pack(layout, src), idx
        valid, slots = [], []
        for z in range(chunk):
            i = t * chunk + z
            if i >= k or not in_plan[i]:   # weight 0, never trained
                valid.append(torch.zeros((), dtype=torch.bool, device=device))
                slots.append(None)
                continue
            data = clients[i]
            n = tree_leaves(data)[0].shape[0]
            perms = [schedule(round_index, population, i, e, n)
                     for e in range(fed.local_epochs)]
            if scaffold is None:
                trained, loss = train_fn(src, data, perms)
            else:
                corr = _mask_pop(scaffold,
                                 scaffold.c_global - scaffold.rows[i])
                trained, loss = train_fn(src, data, perms, corr)
            flatten.pack_into(layout, trained, xz[z])
            ok = (masking.tree_isfinite(trained) if fed.skip_nan_devices
                  else torch.ones((), dtype=torch.bool, device=device))
            if scaffold is not None:
                y_flat = (xz[z] if xz.dtype == torch.float32
                          else flatten.pack(layout, trained))
                _scaffold_delta(scaffold, x_flat, y_flat, cvz[z])
                # a NaN client keeps its previous row
                scaffold.rows[i] += torch.where(ok, cvz[z], 0.0)
            valid.append(ok)
            slots.append(i)
            loss_sum = loss_sum + loss
        valid = torch.stack(valid)
        weights = (valid if staleness_w is None
                   else valid.to(torch.float32) * staleness_w[t])
        if leaf_masks is not None:
            state = aggregate.tree_streaming_fold(
                state, xz, layout, flat_mask, is_simple, weights,
                fed.algorithm, cv_chunk=cvz)
        elif upload is None:
            state = aggregate.streaming_fold(state, xz, flat_mask, is_simple,
                                             weights, fed.algorithm,
                                             wire=wire, cv_chunk=cvz)
        else:
            ef_chunk = None
            if ef_in is not None:   # padding rows carry a zero residual
                ef_chunk = ef_in[t * chunk:(t + 1) * chunk]
                if ef_chunk.shape[0] < chunk:
                    ef_chunk = torch.cat([ef_chunk, ef_chunk.new_zeros(
                        (chunk - ef_chunk.shape[0], ef_chunk.shape[1]))])
            state, rows = _fold_deltas(state, xz, x_flat, upload, ef_chunk,
                                       slots, valid, weights, is_simple,
                                       flat_mask, fed, population,
                                       round_index, cv_chunk=cvz)
            if ef_out is not None:
                ef_out.extend(rows)
        valid_sum = valid_sum + valid.sum()
    ef_rows = torch.stack(ef_out[:k]) if ef_out is not None else None
    cv_rows = scaffold.rows if scaffold is not None else None
    n_real = max(int(in_plan.sum()), 1)
    return state, loss_sum / n_real, valid_sum, cv_rows, ef_rows


# ---------------------------------------------------------------------------
# Server state and the trainer
# ---------------------------------------------------------------------------

@dataclass
class ServerState:
    """``complex`` is the server complex model; for fedhen/noside the
    server simple model IS its M slice.  Decouple keeps an independent
    ``simple_host`` (complex-structured; only its M slice is meaningful)."""
    complex: Tree
    simple_host: Optional[Tree] = None
    round: int = 0


# ---------------------------------------------------------------------------
# Telemetry plumbing (shared by the sync trainer and the async engine)
# ---------------------------------------------------------------------------

class RoundDispatch:
    """Runs a round's execute step under telemetry spans (the reference's
    ``RoundDispatch``).

    With telemetry disabled this calls the step and nothing else.
    Enabled, the first call on the card loads the kernel library
    (``kernels.build.load``, which builds it with nvcc at first use in a
    checkout) under a ``compile`` span, the counterpart of the reference's
    AOT compile; the CPU has no kernels to load and emits no ``compile``.
    Every call runs under an ``execute`` span that ends in
    ``torch.cuda.synchronize()`` on the card, so it measures the round's
    device work and not only the host's launches.  The first call runs
    the step under the roofline walk and emits the ``roofline`` ledger
    (the reference's ``_emit_roofline``, in its key order; its
    ``xla_flops``, XLA's own cost analysis, has no counterpart); the
    walk's full counters stay in ``counters``.  The walk
    only observes: the round's results are bitwise those of a round
    without it."""

    def __init__(self, obs: obslib.Telemetry, device: torch.device):
        self.obs = obs
        self.device = device
        self.loaded = False
        self.walked = False
        self.counters = None    # the walk's counters, once it has run

    def _walk(self, step, *args):
        from repro_torch.roofline import torch_walk
        out, counters = torch_walk.walk(step, *args)
        self.counters = counters
        self.obs.ledger("roofline", {
            "flops": counters["flops"], "hbm_bytes": counters["hbm_bytes"],
            "collective_bytes": counters["total_collective_bytes"]})
        return out

    def __call__(self, step, *args):
        obs = self.obs
        if not obs.enabled:
            return step(*args)
        if not self.loaded and self.device.type == "cuda":
            with obs.span("compile"):
                build.load()
        self.loaded = True
        with obs.span("execute"):
            if self.walked:
                out = step(*args)
            else:
                self.walked = True
                out = self._walk(step, *args)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return out


def emit_round_phases(obs: obslib.Telemetry, *, populations,
                      bytes_down: float, wire: str) -> None:
    """Emit one round's logical phase spans:
    ``broadcast -> train-chunk[t] -> fold -> finalize``.

    These are *point* spans (``dur_s=None``): their wall time lives in
    the enclosing ``execute`` span.  ``populations`` is a sequence of
    ``(name, k, chunk, n_chunks, staleness)`` where ``staleness`` is
    ``None`` for the synchronous engine or the per-chunk staleness
    schedule (in rounds) for the async engine; chunk indices ``t`` run
    over the round's fold stream (simple chunks first, then complex)."""
    if not obs.enabled:
        return
    obs.point_span("broadcast", wire=wire, bytes_down=bytes_down)
    t = 0
    n_folds = 0
    for name, k, chunk, n_chunks, staleness in populations:
        for i in range(n_chunks):
            attrs = {"population": name, "chunk_size": chunk,
                     "clients": max(min(chunk, k - i * chunk), 0)}
            if staleness is not None:
                attrs["staleness"] = int(staleness[i])
            obs.point_span(f"train-chunk[{t}]", **attrs)
            t += 1
        n_folds += n_chunks
    obs.point_span("fold", n_folds=n_folds)
    obs.point_span("finalize")


class FederatedTrainer:
    """Drives T rounds of any of the three algorithms (paper protocol).

    ``device`` defaults to ``"cuda"`` and raises without a CUDA device;
    ``"cpu"`` runs every kernel's plain version.  ``generator`` draws the
    initial params (default: seeded with ``fed.seed``); ``schedule`` is the
    minibatch-order provider (default :class:`SeededSchedule`); ``bits``
    the stochastic-rounding provider (default :class:`SeededBits`);
    ``telemetry`` the event registry (default: the disabled
    :data:`obslib.NOOP`).
    """

    def __init__(self, adapter, fed: FedConfig, client_data: List[Batch], *,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None,
                 schedule: Optional[Schedule] = None,
                 bits: Optional[BitsProvider] = None,
                 telemetry: Optional[obslib.Telemetry] = None):
        fed.validate()
        self.adapter = adapter
        self.fed = fed
        self.obs = obslib.coalesce(telemetry)
        self.device = resolve_device(device)
        self.client_data = [{k: torch.as_tensor(v).to(self.device)
                             for k, v in d.items()} for d in client_data]
        self.sampler = sampling.CohortSampler(
            n_devices=fed.n_devices, n_simple=fed.n_simple,
            participation=fed.participation, seed=fed.seed,
            uniform=fed.sample_uniform)
        self.client_state = client_state.ClientStateMatrix(fed.n_devices)
        if generator is None:
            generator = torch.Generator().manual_seed(fed.seed)
        self.server = ServerState(complex=adapter.init(generator, self.device))
        if fed.algorithm == "decouple":
            self.server.simple_host = tree_map(torch.clone,
                                               self.server.complex)
        self.mask = adapter.subnet_mask(self.server.complex)
        self.k_simple = self.sampler.cap_simple
        self.k_complex = self.sampler.cap_complex
        self.layout = flatten.build_layout(self.server.complex,
                                           total_multiple=fed.agg_block_n)
        self.flat_mask = flatten.pack_mask(self.layout, self.mask,
                                           self.device)
        self.wire = comm.WireSpec(fed.comm_dtype, fed.quant_block,
                                  topk_frac=fed.topk_frac,
                                  stochastic=fed.stochastic_rounding,
                                  error_feedback=fed.error_feedback)
        self.engine_spec = aggregate.EngineSpec.from_config(
            fed, mask=self.mask, layout=self.layout, wire=self.wire)
        # the stream buffer's dtype: deltas and the int8 encode need the
        # f32 result; a bf16 wire streams bf16
        if self.wire.uses_deltas or self.wire.is_quantized:
            self.stream_dtype = torch.float32
        elif not self.wire.is_identity:
            self.stream_dtype = self.wire.payload_dtype
        else:
            self.stream_dtype = getattr(torch, fed.agg_stream_dtype)
        self.schedule = schedule if schedule is not None \
            else SeededSchedule(fed.seed)
        self.bits = bits if bits is not None else SeededBits(fed.seed)
        # SCAFFOLD: one control-variate row c_i per client and the
        # server's c, all zero at start (round 1 then equals the plain
        # protocol's bit for bit)
        self.cv_store: Optional[state_store.FlatStateStore] = None
        self.cv_global: Optional[torch.Tensor] = None
        if fed.variance_reduction == "scaffold":
            self.cv_store = state_store.FlatStateStore(
                fed.n_devices, self.layout.n_flat,
                backend=fed.state_store_backend, device=self.device)
            self.cv_global = torch.zeros((self.layout.n_flat,),
                                         dtype=torch.float32,
                                         device=self.device)
        # the tree engine's per-leaf masks: full-shape bool views of the
        # flat mask (no copy), built once on the trainer's device
        self.leaf_masks: Optional[Tree] = None
        if fed.agg_engine == "tree":
            self.leaf_masks = flatten.unpack(self.layout, self.flat_mask,
                                             cast=False)
        # wire-v2 error-feedback residuals: one packed row per client
        self.ef_store: Optional[state_store.FlatStateStore] = None
        if fed.error_feedback:
            self.ef_store = state_store.FlatStateStore(
                fed.n_devices, self.layout.n_flat,
                backend=fed.state_store_backend, device=self.device)
        # top-k payload lengths (a simple client's delta is zero outside M)
        self.k_top_simple = self.k_top_complex = 0
        if self.wire.uses_deltas:
            self.k_top_simple = comm.topk_count(self.wire,
                                                int(self.flat_mask.sum()))
            self.k_top_complex = comm.topk_count(self.wire,
                                                 self.layout.n_params)
        self.cohort_chunk = self._resolve_cohort_chunk()
        (self.bytes_down_per_round,
         self.bytes_up_per_round) = self._measured_comm_bytes()
        self.bytes_per_round = (self.bytes_down_per_round
                                + self.bytes_up_per_round)
        self.total_bytes = 0.0
        self.total_bytes_down = 0.0
        self.total_bytes_up = 0.0
        cv_layout = self.layout if self.cv_store is not None else None
        self.train_simple = make_client_trainer(adapter.loss_simple, fed,
                                                cv_layout=cv_layout)
        self.train_complex = make_client_trainer(
            adapter.loss_side if fed.algorithm == "fedhen"
            else adapter.loss_complex, fed, cv_layout=cv_layout)
        (chunk_s, _), (chunk_c, _) = self._geometry()
        # the fold's stream buffer, zeroed once: rows are overwritten slot
        # by slot, alignment padding stays zero for the trainer's lifetime
        rows = max(chunk_s, chunk_c)
        self._buffer = torch.zeros((rows, self.layout.n_flat),
                                   dtype=self.stream_dtype, device=self.device)
        # SCAFFOLD's chunk of control-variate deltas (f32, the cv fold's
        # input); an untrained row's stale content is gated by weight 0
        self._cv_buffer = (torch.zeros((rows, self.layout.n_flat),
                                       dtype=torch.float32,
                                       device=self.device)
                           if self.cv_store is not None else None)
        self._dispatch = RoundDispatch(self.obs, self.device)
        # the bounded-lag async engine (core/async_rounds.py) owns the
        # version stack and the staleness schedule; run_round delegates
        self.async_engine = None
        if fed.async_lag > 0:
            from repro_torch.core import async_rounds   # imports this module
            self.async_engine = async_rounds.AsyncRoundEngine(self)
        if self.obs.enabled:
            self._emit_run_config()

    def _resolve_cohort_chunk(self) -> int:
        """``cohort_chunk="auto"`` -> the largest chunk whose per-client
        footprint fits ``agg_memory_budget_mb`` (else the configured
        int)."""
        fed = self.fed
        if fed.cohort_chunk == "auto":
            dtype, qb = self._effective_stream()
            return flatten.auto_cohort_chunk(
                self.layout, budget_bytes=fed.agg_memory_budget_mb * 2**20,
                k=max(self.k_simple, self.k_complex), stream_dtype=dtype,
                quant_block=qb)
        return int(fed.cohort_chunk)

    def _effective_stream(self) -> Tuple[torch.dtype, int]:
        """(dtype, quant_block) of the stream as the wire ships it (the
        reference's rule, which ``cohort_chunk="auto"`` budgets): the wire
        payload when a lossy wire is configured, else the streaming
        dtype."""
        if self.wire.is_quantized:
            return torch.int8, self.wire.quant_block
        if not self.wire.is_identity:
            return self.wire.payload_dtype, 0
        return getattr(torch, self.fed.agg_stream_dtype), 0

    def stream_bytes_per_client(self) -> int:
        """One client's packed stream footprint at the effective wire /
        stream dtype (with the int8 scale sidecar): what
        ``cohort_chunk="auto"`` budgets per client."""
        dtype, qb = self._effective_stream()
        return self.layout.stream_bytes(dtype, quant_block=qb)

    def _geometry(self) -> Tuple[Tuple[int, int], Tuple[int, int]]:
        return (chunk_geometry(self.k_simple, self.cohort_chunk),
                chunk_geometry(self.k_complex, self.cohort_chunk))

    # -- communication accounting ------------------------------------------

    def _measured_comm_bytes(self) -> Tuple[float, float]:
        """(download, upload) bytes per round, measured from the wire
        encoders' output for the true element counts: complex devices
        exchange the whole model, simple devices only M; uploads under
        top-k are the compacted index + value buffers.  Alignment padding
        is never billed.  SCAFFOLD adds the control-variate exchange each
        way (``c`` down, ``dc`` up), raw f32 of the client's trained
        element count (``per_*_cv_bytes``)."""
        n_m = int(self.flat_mask.sum())
        n = self.layout.n_params
        self.per_complex_bytes = comm.wire_bytes(self.wire, n)
        self.per_simple_bytes = comm.wire_bytes(self.wire, n_m)
        self.per_complex_bytes_up = comm.wire_bytes_up(self.wire, n)
        self.per_simple_bytes_up = comm.wire_bytes_up(self.wire, n_m)
        cv = self.cv_store is not None
        self.per_simple_cv_bytes = 4.0 * n_m if cv else 0.0
        self.per_complex_cv_bytes = 4.0 * n if cv else 0.0
        return self._bill(self.k_simple, self.k_complex)

    def _bill(self, n_simple: int, n_complex: int) -> Tuple[float, float]:
        """(download, upload) bytes of ``n_simple`` + ``n_complex``
        participating clients."""
        down = float(
            n_simple * (self.per_simple_bytes + self.per_simple_cv_bytes)
            + n_complex * (self.per_complex_bytes
                           + self.per_complex_cv_bytes))
        up = float(
            n_simple * (self.per_simple_bytes_up + self.per_simple_cv_bytes)
            + n_complex * (self.per_complex_bytes_up
                           + self.per_complex_cv_bytes))
        return down, up

    def _round_bytes(self, plan: sampling.CohortPlan) -> Tuple[float, float]:
        """(download, upload) bytes of one round under ``plan``: only the
        realised clients (an unfilled uniform slot moves no bytes)."""
        return self._bill(plan.n_real_simple, plan.n_real_complex)

    def analytic_bytes_per_round(self) -> float:
        """Param counts x itemsize, down + up — the consistency oracle for
        the measured numbers."""
        params = self.server.complex
        total = sum(x.numel() * x.element_size() for x in tree_leaves(params))
        simple = sum(masking.leaf_mask_size(m, x) * x.element_size()
                     for m, x in zip(tree_leaves(self.mask),
                                     tree_leaves(params)))
        return 2.0 * (self.k_simple * simple + self.k_complex * total)

    # -- telemetry (repro_torch.obs) -----------------------------------------

    def _emit_run_config(self) -> None:
        """One ``run_config`` ledger at construction: the static facts a
        run report leads with (cohort geometry, engine, wire, per-round
        wire cost), with the reference's keys and values."""
        fed = self.fed
        (chunk_s, n_s), (chunk_c, n_c) = self._geometry()
        values = {
            "engine": "async" if self.async_engine is not None else "sync",
            "n_devices": fed.n_devices, "n_simple": fed.n_simple,
            "k_simple": self.k_simple, "k_complex": self.k_complex,
            "participation": fed.participation,
            "sample_uniform": fed.sample_uniform,
            "client_state_bytes": self.client_state.nbytes,
            "cohort_chunk": self.cohort_chunk,
            "n_chunks_simple": n_s, "n_chunks_complex": n_c,
            "comm_dtype": fed.comm_dtype,
            "async_lag": fed.async_lag,
            "n_params": self.layout.n_params,
            "bytes_down_per_round": self.bytes_down_per_round,
            "bytes_up_per_round": self.bytes_up_per_round,
        }
        if self.cv_store is not None:
            values.update({
                "state_store_backend": self.cv_store.backend,
                "state_store_bytes": self.cv_store.nbytes,
            })
        if self.ef_store is not None:
            values.update({
                "ef_store_backend": self.ef_store.backend,
                "ef_store_bytes": self.ef_store.nbytes,
            })
        values.update(aggregate.engine_attrs(self.engine_spec))
        self.obs.ledger("run_config", values)

    def _emit_round_health(self, metrics: Dict[str, float], *,
                           down: float, up: float, k_real: int) -> None:
        """Per-round client-health counters and the comm / client-state /
        store ledgers: the NaN-excluded devices and the weight-0 slots
        (chunk padding and unfilled uniform slots), and the trainer's own
        byte accounting (cumulative totals included, so a run log
        reconciles with ``total_bytes*``; the async engine passes its
        version-aware ``down`` / ``up``).  ``k_real``: the realised
        client count."""
        (chunk_s, n_s), (chunk_c, n_c) = self._geometry()
        k = self.k_simple + self.k_complex
        obs = self.obs
        obs.counter("nan_excluded_devices", k_real - int(metrics["n_valid"]))
        obs.counter("padding_weight0_clients",
                    (n_s * chunk_s - self.k_simple)
                    + (n_c * chunk_c - self.k_complex)
                    + (k - k_real))
        obs.ledger("comm_bytes", {
            "down": down, "up": up,
            "cum_down": self.total_bytes_down,
            "cum_up": self.total_bytes_up,
            "cum_total": self.total_bytes,
        })
        obs.ledger("client_state", {
            "state_bytes": self.client_state.nbytes,
            "tracked_clients": self.client_state.tracked_clients(),
        })
        for name, store in (("state_store", self.cv_store),
                            ("ef_store", self.ef_store)):
            if store is not None:
                obs.ledger(name, {
                    "store_bytes": store.nbytes,
                    "cum_gathered_bytes": store.gathered_bytes,
                    "cum_scattered_bytes": store.scattered_bytes,
                })
        obs.ledger("participation_hist",
                   self.client_state.participation_histogram())

    def emit_phases(self, down: float, staleness=(None, None)) -> None:
        """The round's logical phase spans (:func:`emit_round_phases`) at
        this trainer's chunk geometry; ``staleness``: the async engine's
        per-chunk schedule of each population."""
        (chunk_s, n_s), (chunk_c, n_c) = self._geometry()
        emit_round_phases(self.obs, populations=[
            ("simple", self.k_simple, chunk_s, n_s, staleness[0]),
            ("complex", self.k_complex, chunk_c, n_c, staleness[1])],
            bytes_down=down, wire=self.fed.comm_dtype)

    # -- the round -----------------------------------------------------------

    def _upload(self, k_top: int, ids) -> Optional[WireUploadCtx]:
        """One population's wire-v2 context (its EF rows gathered), or
        ``None`` on a dense-upload wire."""
        if not self.wire.uses_deltas:
            return None
        rows = self.ef_store.gather(ids) if self.ef_store is not None \
            else None
        return WireUploadCtx(self.wire, k_top, rows, self.bits)

    def _scaffold(self, ids, pop_mask: Optional[torch.Tensor],
                  data: Batch) -> Optional[ScaffoldCtx]:
        """One population's SCAFFOLD context (its cv rows gathered), or
        ``None`` when SCAFFOLD is off."""
        if self.cv_store is None:
            return None
        k_steps = local_step_count(data, self.fed)
        return ScaffoldCtx(self.cv_store.gather(ids), self.cv_global,
                           pop_mask, 1.0 / (k_steps * self.fed.lr))

    @staticmethod
    def _scatter_rows(store: state_store.FlatStateStore,
                      plan: sampling.CohortPlan, rows_s, rows_c,
                      set_scale: Callable) -> None:
        """Write one round's updated store rows back for REAL slots only
        (pad slots wrap real clients' ids: writing them would clobber the
        row that client just wrote) and record each row's L2 norm through
        ``set_scale`` (a client-state matrix column)."""
        for ids, real, rows in ((plan.simple_ids, plan.simple_real, rows_s),
                                (plan.complex_ids, plan.complex_real,
                                 rows_c)):
            real = np.asarray(real, bool)
            if not real.any():
                continue
            ids = np.asarray(ids, np.int64)[real]
            rows = rows[torch.from_numpy(real).to(rows.device)]
            store.scatter(ids, rows)
            set_scale(ids, torch.linalg.vector_norm(
                rows.to(torch.float64), dim=1).cpu().numpy())

    def run_round(self) -> Dict[str, float]:
        if self.async_engine is not None:
            return self.async_engine.run_round()
        obs = self.obs
        obs.set_round(self.server.round)
        with obs.span("round", engine="sync"):
            with obs.span("sample_gather"):
                plan = self.sampler.plan(self.server.round)
                data = self._gather(plan)
            metrics = self._commit(plan, *self._dispatch(
                self._execute_sync, plan, data))
            down, up = self._round_bytes(plan)
            self._add_bytes(down, up)
            if obs.enabled:
                self.emit_phases(down)
                self._emit_round_health(
                    metrics, down=down, up=up,
                    k_real=plan.n_real_simple + plan.n_real_complex)
        return metrics

    def _add_bytes(self, down: float, up: float) -> None:
        self.total_bytes_down += down
        self.total_bytes_up += up
        self.total_bytes += down + up

    def _gather(self, plan: sampling.CohortPlan) -> Tuple[List[Batch],
                                                          List[Batch]]:
        """The plan's simple and complex clients' datasets, in slot
        order."""
        return ([self.client_data[i] for i in plan.simple_ids],
                [self.client_data[i] for i in plan.complex_ids])

    def _execute_sync(self, plan: sampling.CohortPlan, data):
        """The synchronous round's execute step: the broadcast's wire trip
        (clients train on the DECODED copy), then :meth:`_execute`."""
        bc_complex = comm.broadcast_roundtrip(self.wire, self.layout,
                                              self.server.complex)
        src_simple = (comm.broadcast_roundtrip(self.wire, self.layout,
                                               self.server.simple_host)
                      if self.fed.algorithm == "decouple" else bc_complex)
        return self._execute(plan, data, lambda _: src_simple,
                             lambda _: bc_complex)

    def _execute(self, plan: sampling.CohortPlan, data, get_src_s,
                 get_src_c, async_s=(None, None), async_c=(None, None)):
        """Train and fold one round's two populations and finalize: the
        work of the reference's jitted round.  ``data``: the populations'
        datasets (:meth:`_gather`); ``get_src_*``: their
        :func:`stream_population` sources; ``async_*``: their
        ``(version_idx, staleness_w)`` (``None`` each: the synchronous
        round).  Returns ``(new_complex, new_simple_host, metrics, cv_out,
        ef_out)`` for :meth:`_commit`: ``metrics`` as 0-d tensors in the
        reference's key order, ``cv_out`` the new server control variate
        and the cohort's updated cv rows (``None`` without SCAFFOLD),
        ``ef_out`` the updated EF rows (``None`` without EF)."""
        fed = self.fed
        scaffold = self.cv_store is not None
        if self.leaf_masks is not None:
            state = aggregate.tree_streaming_init(
                self.server.complex, fed.algorithm, self.layout,
                scaffold=scaffold)
        else:
            state = aggregate.streaming_init(self.layout, fed.algorithm,
                                             self.device, scaffold=scaffold)
        (chunk_s, n_s), (chunk_c, n_c) = self._geometry()
        common = dict(round_index=self.server.round, schedule=self.schedule,
                      fed=fed, layout=self.layout, flat_mask=self.flat_mask,
                      buffer=self._buffer, wire=self.wire,
                      cv_buffer=self._cv_buffer, leaf_masks=self.leaf_masks)
        data_s, data_c = data
        state, loss_s, valid_s, cv_s, ef_s = stream_population(
            state, get_src_s, self.train_simple, data_s,
            population="simple", chunk=chunk_s, n_chunks=n_s,
            upload=self._upload(self.k_top_simple, plan.simple_ids),
            real=plan.simple_real,
            scaffold=self._scaffold(plan.simple_ids, self.flat_mask,
                                    data_s[0]),
            version_idx=async_s[0], staleness_w=async_s[1], **common)
        state, loss_c, valid_c, cv_c, ef_c = stream_population(
            state, get_src_c, self.train_complex, data_c,
            population="complex", chunk=chunk_c, n_chunks=n_c,
            upload=self._upload(self.k_top_complex, plan.complex_ids),
            real=plan.complex_real,
            scaffold=self._scaffold(plan.complex_ids, None, data_c[0]),
            version_idx=async_c[0], staleness_w=async_c[1], **common)
        if self.leaf_masks is not None:
            new_complex, new_simple_host = aggregate.tree_streaming_finalize(
                state, self.leaf_masks, fed.algorithm, self.server.complex)
        else:
            new_complex, new_simple_host = aggregate.streaming_finalize(
                state, self.layout, self.flat_mask, fed.algorithm)
        cv_out = None
        if scaffold:
            # c += cv_acc / N over ALL devices (non-participants add 0);
            # the jitted reference multiplies by f32(1/N) and fuses the
            # add into an FMA, which f64 reproduces in f32
            inv_n = float(np.float32(1.0 / fed.n_devices))
            cv_out = ((state.cv_acc.to(torch.float64) * inv_n
                       + self.cv_global.to(torch.float64)
                       ).to(torch.float32), cv_s, cv_c)
        ef_out = (ef_s, ef_c) if self.ef_store is not None else None
        # the reference's jit returns its metrics with sorted keys
        metrics = {"loss_complex": loss_c, "loss_simple": loss_s,
                   "n_valid": valid_s + valid_c}
        return new_complex, new_simple_host, metrics, cv_out, ef_out

    def _commit(self, plan: sampling.CohortPlan, new_complex,
                new_simple_host, metrics, cv_out, ef_out) -> Dict[str, float]:
        """Commit one executed round: the SCAFFOLD and EF rows scattered
        back, the client-state record, the new server state.  Returns the
        metrics as floats; byte billing is the caller's."""
        if cv_out is not None:
            self.cv_global = cv_out[0]
            self._scatter_rows(self.cv_store, plan, cv_out[1], cv_out[2],
                               self.client_state.set_cv_scale)
        if ef_out is not None:
            self._scatter_rows(self.ef_store, plan, ef_out[0], ef_out[1],
                               self.client_state.set_ef_scale)
        self.client_state.record_round(plan.real_ids(), plan.round_index)
        self.server = ServerState(complex=new_complex,
                                  simple_host=new_simple_host,
                                  round=self.server.round + 1)
        return {k: float(v) for k, v in metrics.items()}

    def evaluate(self, test_batch: Batch) -> Dict[str, float]:
        """Server-model metrics.  For decouple, the simple accuracy comes
        from the simple host; otherwise from the complex model's M slice
        (which IS the server simple model)."""
        batch = {k: torch.as_tensor(v).to(self.device)
                 for k, v in test_batch.items()}
        m = {k: float(v) for k, v in
             self.adapter.evaluate(self.server.complex, batch).items()}
        if self.fed.algorithm == "decouple":
            ms = self.adapter.evaluate(self.server.simple_host, batch)
            m["acc_simple"] = float(ms["acc_simple"])
        m["mbytes"] = self.total_bytes / 1e6
        m["mbytes_down"] = self.total_bytes_down / 1e6
        m["mbytes_up"] = self.total_bytes_up / 1e6
        return m

    def run(self, rounds: int, *, eval_every: int = 0,
            test_batch: Optional[Batch] = None,
            log: Optional[Callable[[str], None]] = None) -> List[Dict]:
        """``rounds`` rounds, evaluated on ``test_batch`` after every round
        whose completed count (``server.round``, which a resumed trainer
        carries on) is a multiple of ``eval_every``.  At such a round the
        reference's line ``round N: k=v, ...`` (the metrics in their dict
        order) goes to ``log`` and, as a ``log`` event, to the telemetry,
        after the ``eval`` ledger stamped with the completed count.
        Returns each round's metrics."""
        history = []
        obs = self.obs
        for _ in range(rounds):
            metrics = self.run_round()
            done = self.server.round
            due = bool(eval_every) and done % eval_every == 0
            if due and test_batch is not None:
                ev = self.evaluate(test_batch)
                metrics.update(ev)
                obs.set_round(done)
                obs.ledger("eval", ev)
            metrics["round"] = done
            history.append(metrics)
            if (log is not None or obs.enabled) and due:
                line = f"round {done}: " + ", ".join(
                    f"{k}={v:.4f}" for k, v in metrics.items()
                    if k != "round")
                obs.log(line)
                if log is not None:
                    log(line)
        return history


def rounds_to_target(history: List[Dict], key: str, target: float) -> int:
    """Paper's evaluation metric: first round reaching the target.
    Accuracy-like metrics (name holds ``acc``) are reached at-or-above the
    target, loss-like metrics at-or-below (``obs.report``'s rule, shared
    with the run report)."""
    from repro_torch.obs.report import higher_is_better
    maximize = higher_is_better(key)
    for h in history:
        if key in h and (h[key] >= target if maximize
                         else h[key] <= target):
            return h["round"]
    return -1
