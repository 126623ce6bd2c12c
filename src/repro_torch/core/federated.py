"""Federated runtime: local client training, server state, the sync round.

The port of ``repro.core.federated``'s synchronous engine on the flat fold
and the f32 wire, for the paper's three algorithms over any adapter:

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
``n_valid``, and so cannot change the round.

**Minibatch order.**  The reference draws each epoch's permutation from
threefry keys that PyTorch cannot reproduce, so the client trainer takes
its index schedule from a provider: ``schedule(round, population, slot,
epoch, n) -> permutation of range(n)``.  :class:`SeededSchedule` (the
default) seeds a ``torch.Generator`` per ``(seed, round, population, slot,
epoch)``, which keeps a round independent of how its cohort is chunked;
tests fill the provider with the reference's own permutations.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import FedConfig
from repro_torch.core import aggregate, comm, flatten, masking, sampling
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.optim.sgd import sgd_update
from repro_torch.tree import Tree, tree_flatten, tree_leaves, tree_map, \
    tree_unflatten

Batch = Dict[str, torch.Tensor]
Schedule = Callable[[int, str, int, int, int], Sequence[int]]

POPULATIONS = ("simple", "complex")


class SeededSchedule:
    """Default minibatch-order provider: ``torch.randperm`` from a CPU
    ``torch.Generator`` seeded by ``(seed, round, population, slot,
    epoch)`` — the same permutations on every device and chunking."""

    def __init__(self, seed: int):
        self.seed = int(seed)

    def __call__(self, round_index: int, population: str, slot: int,
                 epoch: int, n: int) -> torch.Tensor:
        words = np.random.SeedSequence(
            [self.seed & sampling._SEED_MASK, round_index,
             POPULATIONS.index(population), slot, epoch]
        ).generate_state(2, np.uint32)
        seed = ((int(words[0]) << 32) | int(words[1])) & ((1 << 63) - 1)
        return torch.randperm(n, generator=torch.Generator().manual_seed(seed))


# ---------------------------------------------------------------------------
# Local client optimization (Alg. 2)
# ---------------------------------------------------------------------------

def make_client_trainer(loss_fn: Callable[[Tree, Batch], torch.Tensor],
                        fed: FedConfig):
    """Returns ``train(params, data, perms) -> (params', mean_loss)``.

    ``data``: dict of tensors with leading dim N_i (the client's local
    dataset).  ``perms``: one permutation of ``range(N_i)`` per epoch; each
    epoch takes ``steps = max(N_i // batch_size, 1)`` minibatches from the
    front of its permutation.  ``params`` is never modified; the returned
    tree is new (a leaf the loss never touches is returned as is).
    ``mean_loss`` is a 0-d tensor on the data's device.
    """

    def full_loss(p, anchor, batch):
        loss = loss_fn(p, batch)
        if fed.prox_mu:
            sq = sum(torch.sum(torch.square(a.float() - b.float()))
                     for a, b in zip(tree_leaves(p), tree_leaves(anchor)))
            loss = loss + 0.5 * fed.prox_mu * sq
        return loss

    def train(params: Tree, data: Batch, perms: Sequence) -> Tuple[Tree,
                                                                   torch.Tensor]:
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
                with torch.no_grad():
                    p = sgd_update(tree_map(lambda x: x.detach(), p),
                                   tree_unflatten(treedef, grads), fed.lr,
                                   fed.clip_norm)
                losses.append(loss.detach())
        return (tree_map(lambda x: x.detach(), p),
                torch.stack(losses).mean())

    return train


def local_step_count(data: Batch, fed: FedConfig) -> int:
    """SGD steps one client runs on its dataset ``data``:
    ``max(N_i // batch_size, 1) * local_epochs``."""
    n = tree_leaves(data)[0].shape[0]
    return max(n // fed.batch_size, 1) * fed.local_epochs


# ---------------------------------------------------------------------------
# The chunk stream
# ---------------------------------------------------------------------------

def chunk_geometry(k: int, cohort_chunk: int) -> Tuple[int, int]:
    """(chunk, n_chunks) of one population: ``chunk <= k``, the population
    padded up to a chunk multiple with weight-0 slots."""
    chunk = k if cohort_chunk <= 0 else min(cohort_chunk, k)
    return chunk, -(-k // chunk)


def stream_population(state: aggregate.StreamState, src: Tree, train_fn,
                      clients: List[Batch], *, population: str,
                      round_index: int, schedule: Schedule, fed: FedConfig,
                      layout: flatten.FlatLayout, flat_mask: torch.Tensor,
                      buffer: torch.Tensor, chunk: int, n_chunks: int):
    """Train one population chunk by chunk and fold each chunk into the
    running sums.

    ``clients`` are the population's ``k`` sampled datasets in slot order;
    slot ``i`` trains from ``src`` on ``clients[i]`` with the schedule's
    permutations for ``(round_index, population, i, epoch)``.  Each trained
    client is packed into row ``z`` of ``buffer[:chunk]`` (zero-padded once
    at allocation, in the fold's stream dtype); a client whose result is
    not all finite gets validity 0 (when ``skip_nan_devices``).

    Returns ``(state, mean_loss, n_valid)`` — 0-d tensors; the mean loss
    is normalized by ``k``."""
    k = len(clients)
    device = buffer.device
    xz = buffer[:chunk]
    is_simple = torch.full((chunk,), population == "simple",
                           dtype=torch.bool, device=device)
    loss_sum = torch.zeros((), device=device)
    valid_sum = torch.zeros((), device=device)
    for t in range(n_chunks):
        valid = []
        for z in range(chunk):
            i = t * chunk + z
            if i >= k:       # padding slot: weight 0, never trained
                valid.append(torch.zeros((), dtype=torch.bool, device=device))
                continue
            data = clients[i]
            n = tree_leaves(data)[0].shape[0]
            perms = [schedule(round_index, population, i, e, n)
                     for e in range(fed.local_epochs)]
            trained, loss = train_fn(src, data, perms)
            flatten.pack_into(layout, trained, xz[z])
            valid.append(masking.tree_isfinite(trained)
                         if fed.skip_nan_devices
                         else torch.ones((), dtype=torch.bool, device=device))
            loss_sum = loss_sum + loss
        valid = torch.stack(valid)
        state = aggregate.streaming_fold(state, xz, flat_mask, is_simple,
                                         valid, fed.algorithm)
        valid_sum = valid_sum + valid.sum()
    return state, loss_sum / k, valid_sum


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


class FederatedTrainer:
    """Drives T rounds of any of the three algorithms (paper protocol).

    ``device`` defaults to ``"cuda"`` and raises without a CUDA device;
    ``"cpu"`` runs every kernel's plain version.  ``generator`` draws the
    initial params (default: seeded with ``fed.seed``); ``schedule`` is the
    minibatch-order provider (default :class:`SeededSchedule`).
    """

    def __init__(self, adapter, fed: FedConfig, client_data: List[Batch], *,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None,
                 schedule: Optional[Schedule] = None):
        fed.validate()
        self.adapter = adapter
        self.fed = fed
        self.device = resolve_device(device)
        self.client_data = [{k: torch.as_tensor(v).to(self.device)
                             for k, v in d.items()} for d in client_data]
        self.sampler = sampling.CohortSampler(
            n_devices=fed.n_devices, n_simple=fed.n_simple,
            participation=fed.participation, seed=fed.seed,
            uniform=fed.sample_uniform)
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
        self.stream_dtype = getattr(torch, fed.agg_stream_dtype)
        self.schedule = schedule if schedule is not None \
            else SeededSchedule(fed.seed)
        self.cohort_chunk = self._resolve_cohort_chunk()
        (self.bytes_down_per_round,
         self.bytes_up_per_round) = self._measured_comm_bytes()
        self.bytes_per_round = (self.bytes_down_per_round
                                + self.bytes_up_per_round)
        self.total_bytes = 0.0
        self.total_bytes_down = 0.0
        self.total_bytes_up = 0.0
        self.train_simple = make_client_trainer(adapter.loss_simple, fed)
        self.train_complex = make_client_trainer(
            adapter.loss_side if fed.algorithm == "fedhen"
            else adapter.loss_complex, fed)
        (chunk_s, _), (chunk_c, _) = self._geometry()
        # the fold's stream buffer, zeroed once: rows are overwritten slot
        # by slot, alignment padding stays zero for the trainer's lifetime
        self._buffer = torch.zeros((max(chunk_s, chunk_c), self.layout.n_flat),
                                   dtype=self.stream_dtype, device=self.device)

    def _resolve_cohort_chunk(self) -> int:
        fed = self.fed
        if fed.cohort_chunk == "auto":
            return flatten.auto_cohort_chunk(
                self.layout, budget_bytes=fed.agg_memory_budget_mb * 2**20,
                k=max(self.k_simple, self.k_complex),
                stream_dtype=self.stream_dtype)
        return int(fed.cohort_chunk)

    def _geometry(self) -> Tuple[Tuple[int, int], Tuple[int, int]]:
        return (chunk_geometry(self.k_simple, self.cohort_chunk),
                chunk_geometry(self.k_complex, self.cohort_chunk))

    # -- communication accounting ------------------------------------------

    def _measured_comm_bytes(self) -> Tuple[float, float]:
        """(download, upload) bytes per round, measured from the wire
        encoder's output for the true element counts: complex devices
        exchange the whole model, simple devices only M.  Alignment padding
        is never billed."""
        n_m = int(self.flat_mask.sum())
        self.per_complex_bytes = comm.wire_bytes(self.wire,
                                                 self.layout.n_params)
        self.per_simple_bytes = comm.wire_bytes(self.wire, n_m)
        one_way = float(self.k_simple * self.per_simple_bytes
                        + self.k_complex * self.per_complex_bytes)
        return one_way, one_way

    def analytic_bytes_per_round(self) -> float:
        """Param counts x itemsize, down + up — the consistency oracle for
        the measured numbers."""
        total = simple = 0
        for m, x in zip(tree_leaves(self.mask),
                        tree_leaves(self.server.complex)):
            nbytes = x.numel() * x.element_size()
            total += nbytes
            simple += nbytes if m else 0
        return 2.0 * (self.k_simple * simple + self.k_complex * total)

    # -- the round -----------------------------------------------------------

    def run_round(self) -> Dict[str, float]:
        fed = self.fed
        plan = self.sampler.plan(self.server.round)
        bc_complex = comm.broadcast_roundtrip(self.wire, self.layout,
                                              self.server.complex)
        src_simple = (comm.broadcast_roundtrip(self.wire, self.layout,
                                               self.server.simple_host)
                      if fed.algorithm == "decouple" else bc_complex)
        state = aggregate.streaming_init(self.layout, fed.algorithm,
                                         self.device)
        (chunk_s, n_s), (chunk_c, n_c) = self._geometry()
        common = dict(round_index=self.server.round, schedule=self.schedule,
                      fed=fed, layout=self.layout, flat_mask=self.flat_mask,
                      buffer=self._buffer)
        state, loss_s, valid_s = stream_population(
            state, src_simple, self.train_simple,
            [self.client_data[i] for i in plan.simple_ids],
            population="simple", chunk=chunk_s, n_chunks=n_s, **common)
        state, loss_c, valid_c = stream_population(
            state, bc_complex, self.train_complex,
            [self.client_data[i] for i in plan.complex_ids],
            population="complex", chunk=chunk_c, n_chunks=n_c, **common)
        new_complex, new_simple_host = aggregate.streaming_finalize(
            state, self.layout, self.flat_mask, fed.algorithm)
        self.server = ServerState(complex=new_complex,
                                  simple_host=new_simple_host,
                                  round=self.server.round + 1)
        self.total_bytes_down += self.bytes_down_per_round
        self.total_bytes_up += self.bytes_up_per_round
        self.total_bytes += self.bytes_per_round
        return {"loss_simple": float(loss_s), "loss_complex": float(loss_c),
                "n_valid": float(valid_s + valid_c)}

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
        history = []
        for r in range(rounds):
            metrics = self.run_round()
            evaluated = bool(eval_every and test_batch is not None
                             and (r + 1) % eval_every == 0)
            if evaluated:
                metrics.update(self.evaluate(test_batch))
            metrics["round"] = self.server.round
            history.append(metrics)
            if log is not None and evaluated:
                log(f"round {self.server.round}: " + ", ".join(
                    f"{k}={v:.4f}" for k, v in metrics.items()
                    if k != "round"))
        return history


def rounds_to_target(history: List[Dict], key: str, target: float) -> int:
    """Paper's evaluation metric: first round reaching the target.
    Accuracy-like metrics (name holds ``acc``) are reached at-or-above the
    target, loss-like metrics at-or-below."""
    maximize = "acc" in key
    for h in history:
        if key in h and (h[key] >= target if maximize
                         else h[key] <= target):
            return h["round"]
    return -1
