"""Asynchronous rounds: bounded-lag chunk streaming with staleness-weighted
folds (FedAsync semantics), the port of ``repro.core.async_rounds``.

**Bounded-lag contract** (the reference's).  Let ``F`` be the chunk folds
of one round (simple chunks first, then complex) and ``t`` a chunk's
position in that stream.  With ``FedConfig.async_lag = L`` chunk ``t`` of
round ``r`` trains on the server model published ``ceil((L - t) / F)``
rounds ago, clamped to ``[0, r]`` (:func:`fold_schedule`).  ``L = 0``
trains every chunk on the fresh broadcast: bit for bit the synchronous
round.

**Versions.**  The engine keeps the last ``ceil(L / F) + 1`` published
server models.  The fresh one is the trainer's own server tree, and each
stale one is a server tree an earlier round published, kept as it is: in
the params' own dtype, with no copy (the reference keeps all of them as a
``(V, n_flat)`` f32 stack; every published model comes out of the
finalize cast to the params' dtypes, so the two hold the same values).  A
version crosses the wire only when a chunk of the round selects it, once,
through the same encode/decode trip (no key) as the synchronous
broadcast.  Download billing is version-aware: a client whose cached
``version_tag`` (``core.client_state``) already names the version its
chunk trains on costs 0 (``comm.VersionCache`` is the dict semantics it
is held to).  A server replaced from outside the engine (checkpoint
restore) resets the versions and the clients' tags.

**Staleness-weighted folds.**  A stale upload folds at ``1 / (1 + s)^a``
times its validity (``FedConfig.async_staleness = "none"``: weight 1), in
the same masked-weight path that gates NaN and padding clients: fresh
chunks fold at exactly 1.0, which is why lag 0 is bitwise.

The engine shares the synchronous machinery: the trainer's client
trainers, folds and finalize, and the ONE chunk stream
``federated.stream_population`` with its async extras, through
``FederatedTrainer._execute`` and ``_commit``.

**Telemetry** rides the trainer's registry: a ``round`` span with
``engine="async"`` and the lag, ``sample_gather``, ``execute`` (the
versions' wire trips happen inside it, as the reference decodes its stack
inside its jit), the phase spans with each chunk's staleness, then
:meth:`AsyncRoundEngine._emit_async_health` (the ``staleness_hist``
ledger, the version-cache hit / miss counters as per-round deltas) and
the trainer's health counters and ledgers.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import comm, federated
from repro_torch.tree import Tree

STALENESS_SCHEMES = ("poly", "none")


def staleness_weight(staleness, *, scheme: str = "poly",
                     decay: float = 0.5) -> torch.Tensor:
    """Fold coefficient of an upload that trained on a stale broadcast:
    ``"poly"`` the FedAsync decay ``1 / (1 + s)^decay``, ``"none"`` 1.

    Returns a CPU f32 tensor of ``staleness``'s shape, exactly 1.0 at
    ``s = 0`` (the lag-0 parity relies on it).  ``(1 + s) ** f32(-decay)``
    in f32 on the CPU gives the reference's values bit for bit."""
    s = torch.as_tensor(np.asarray(staleness), dtype=torch.float32)
    if scheme == "none":
        return torch.ones_like(s)
    if scheme == "poly":
        return (1.0 + s) ** torch.tensor(np.float32(-decay))
    raise ValueError(f"unknown staleness scheme {scheme!r} "
                     f"(one of {STALENESS_SCHEMES})")


def fold_schedule(n_folds: int, lag: int, round_index: int) -> np.ndarray:
    """Per-chunk broadcast staleness of one round's fold stream:
    position ``t`` trains on the model published ``ceil((lag - t) /
    n_folds)`` rounds ago, clamped to ``[0, round_index]``.  All zeros at
    ``lag = 0``."""
    t = np.arange(n_folds)
    d = -((t - lag) // n_folds)          # ceil((lag - t) / n_folds)
    return np.minimum(np.maximum(d, 0), round_index)


class AsyncRoundEngine:
    """Drives asynchronous rounds for a :class:`~repro_torch.core.
    federated.FederatedTrainer`, which delegates ``run_round`` here when
    ``FedConfig.async_lag > 0``.

    The engine owns the versions, the staleness schedule and the
    version-aware byte accounting; the server state stays on the trainer.
    Construct it directly with an explicit ``lag`` to run the async path
    at a lag the trainer's config would not choose (the lag-0 parity tests
    do)."""

    def __init__(self, trainer, *, lag: Optional[int] = None):
        fed = trainer.fed
        self.trainer = trainer
        self.lag = fed.async_lag if lag is None else lag
        if self.lag < 0:
            raise ValueError(f"lag must be >= 0, got {self.lag}")
        (self.chunk_s, self.n_chunks_s), (self.chunk_c, self.n_chunks_c) = \
            trainer._geometry()
        self.folds_per_round = self.n_chunks_s + self.n_chunks_c
        # the deepest version any chunk can reach, plus the fresh one
        self.n_versions = -(-self.lag // self.folds_per_round) + 1
        self._reset_versions()
        self.last_bytes_down = 0.0
        self.last_bytes_up = 0.0
        self._dispatch = federated.RoundDispatch(trainer.obs, trainer.device)

    # -- versions ------------------------------------------------------------

    def _reset_versions(self) -> None:
        """(Re)seed the versions from the trainer's CURRENT server: every
        stale slot becomes the current model (the history of a replaced
        server is unknown), and the clients' cached version tags are
        wiped, and so are the cumulative cache tallies (telemetry emits
        their per-round deltas, so where the last round left off is
        remembered too).  Called at construction and when
        ``trainer.server`` was replaced from outside the engine
        (checkpoint restore)."""
        tr = self.trainer
        depth = self.n_versions - 1
        self._stale: List[Tree] = [tr.server.complex] * depth
        self._stale_host: List[Tree] = [tr.server.simple_host] * depth
        tr.client_state.reset_version_tags()
        self.cache_hits = 0
        self.cache_misses = 0
        self._seen_cache_counts = (0, 0)
        self._published_server = tr.server

    def versions(self) -> List[Tree]:
        """The complex models a chunk can train on, fresh first (index =
        staleness in rounds)."""
        return [self.trainer.server.complex] + self._stale

    def schedule(self, round_index: int) -> Tuple[np.ndarray, np.ndarray]:
        """(staleness_simple, staleness_complex) of one round: the fold
        stream split back into the two populations."""
        s_all = fold_schedule(self.folds_per_round, self.lag, round_index)
        return s_all[:self.n_chunks_s], s_all[self.n_chunks_s:]

    def _sources(self, models: List[Tree]):
        """``get_src`` of :func:`federated.stream_population` over
        ``models`` (fresh first): each version selected this round goes
        through the broadcast's wire trip once."""
        tr = self.trainer
        decoded: Dict[int, Tree] = {}

        def get_src(idx: int) -> Tree:
            if idx not in decoded:
                decoded[idx] = comm.broadcast_roundtrip(tr.wire, tr.layout,
                                                        models[idx])
            return decoded[idx]
        return get_src

    # -- byte accounting -----------------------------------------------------

    def _bill_download(self, plan, s_s, s_c, round_index: int) -> float:
        """One round's download: each real client fetches the version its
        chunk trains on, billed once per (client, version) by the
        client-state matrix's tag compare (a cached stale broadcast costs
        0).  Pad slots wrap real clients and are never billed."""
        tr = self.trainer
        down = 0.0
        for ids, real, staleness, chunk, nbytes in (
                (plan.simple_ids, plan.simple_real, s_s, self.chunk_s,
                 tr.per_simple_bytes),
                (plan.complex_ids, plan.complex_real, s_c, self.chunk_c,
                 tr.per_complex_bytes)):
            real = np.asarray(real, bool)
            pos = np.arange(np.asarray(ids).size)
            tags = round_index - np.asarray(staleness)[pos // chunk]
            billed, hits, misses = tr.client_state.bill_downloads(
                np.asarray(ids)[real], tags[real], nbytes)
            down += billed
            self.cache_hits += hits
            self.cache_misses += misses
        return float(down)

    # -- the round -----------------------------------------------------------

    def _emit_async_health(self, s_s, s_c) -> None:
        """Async client health: the round's per-chunk staleness histogram
        (``{staleness: chunk count}`` over the fold stream) and the
        version-cache hit / miss deltas of the round (a hit is a stale
        broadcast the client already held, which the billing credits)."""
        obs = self.trainer.obs
        hist: dict = {}
        for s in list(s_s) + list(s_c):
            hist[int(s)] = hist.get(int(s), 0) + 1
        obs.ledger("staleness_hist",
                   {str(k): v for k, v in sorted(hist.items())})
        seen_h, seen_m = self._seen_cache_counts
        obs.counter("version_cache_hit", self.cache_hits - seen_h)
        obs.counter("version_cache_miss", self.cache_misses - seen_m)
        self._seen_cache_counts = (self.cache_hits, self.cache_misses)

    def run_round(self) -> Dict[str, float]:
        """One async round: schedule the staleness, train and fold the
        chunk stream on the selected versions, publish the new model into
        the versions, and bill the bytes."""
        tr = self.trainer
        obs = tr.obs
        obs.set_round(tr.server.round)
        with obs.span("round", engine="async", lag=self.lag):
            with obs.span("sample_gather"):
                if tr.server is not self._published_server:
                    # replaced from outside (checkpoint restore): the
                    # versions must follow it, or chunks would train on
                    # the discarded model
                    self._reset_versions()
                start = tr.server
                r = start.round
                s_s, s_c = self.schedule(r)
                weight = lambda s: staleness_weight(
                    s, scheme=tr.fed.async_staleness,
                    decay=tr.fed.async_decay).to(tr.device)
                w_s, w_c = weight(s_s), weight(s_c)
                plan = tr.sampler.plan(r)
                data = tr._gather(plan)
            src_c = self._sources([start.complex] + self._stale)
            src_s = (self._sources([start.simple_host] + self._stale_host)
                     if tr.fed.algorithm == "decouple" else src_c)
            metrics = tr._commit(plan, *self._dispatch(
                tr._execute, plan, data, src_s, src_c, (s_s, w_s),
                (s_c, w_c)))
            # publish: the round's starting model becomes one round stale
            if self._stale:
                self._stale = [start.complex] + self._stale[:-1]
                self._stale_host = [start.simple_host] + self._stale_host[:-1]
            self._published_server = tr.server
            down = self._bill_download(plan, s_s, s_c, r)
            # SCAFFOLD's cv exchange: c is republished every round (no
            # version to cache), the c_i deltas ride the upload, both raw
            down += float(plan.n_real_simple * tr.per_simple_cv_bytes
                          + plan.n_real_complex * tr.per_complex_cv_bytes)
            up = float(plan.n_real_simple * (tr.per_simple_bytes_up
                                             + tr.per_simple_cv_bytes)
                       + plan.n_real_complex * (tr.per_complex_bytes_up
                                                + tr.per_complex_cv_bytes))
            self.last_bytes_down, self.last_bytes_up = down, up
            tr._add_bytes(down, up)
            if obs.enabled:
                tr.emit_phases(down, (s_s, s_c))
                self._emit_async_health(s_s, s_c)
                tr._emit_round_health(
                    metrics, down=down, up=up,
                    k_real=plan.n_real_simple + plan.n_real_complex)
        return metrics
