"""Per-client host state: one flat ``(N_clients + 1, width)`` matrix.

The port's own copy of ``repro.core.client_state`` (numpy only, the same
column schema and methods): every per-client scalar the runtime tracks
lives in ONE flat numpy matrix, and rounds touch it only through
vectorized gather/scatter by the sampled ids, so per-round host cost is
O(cohort) whatever the population size.

Columns (:data:`COLUMNS`, one f64 each): ``participation`` (rounds the
client was really sampled in), ``last_round`` (-1 = never),
``version_tag`` (the server version last downloaded, -1 = none; the async
engine's billing), ``ef_scale`` (L2 norm of the client's error-feedback
residual row, written on every residual-store scatter) and ``cv_scale``
(the same for a SCAFFOLD control variate).  Row ``N`` is a scratch
sentinel that pad slots may target; every read path masks it out.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

COLUMNS = ("participation", "last_round", "version_tag",
           "ef_scale", "cv_scale")

_PART = COLUMNS.index("participation")
_LAST = COLUMNS.index("last_round")
_TAG = COLUMNS.index("version_tag")
_CV = COLUMNS.index("cv_scale")
_EF = COLUMNS.index("ef_scale")

NEVER = -1.0          # version_tag / last_round value for "no history"


class ClientStateMatrix:
    """All per-client runtime state as one flat host matrix.

    Mutating methods take *unique* real client ids (one slot per client
    per call — the sampler guarantees it; duplicate ids in one call
    would collapse into one row update, like any scatter).
    """

    def __init__(self, n_clients: int):
        if n_clients <= 0:
            raise ValueError(f"n_clients must be > 0, got {n_clients}")
        self.n_clients = int(n_clients)
        self._m = np.zeros((self.n_clients + 1, len(COLUMNS)), np.float64)
        self._m[:, _LAST] = NEVER
        self._m[:, _TAG] = NEVER

    # -- schema ---------------------------------------------------------------

    @property
    def columns(self) -> Tuple[str, ...]:
        return COLUMNS

    @property
    def sentinel(self) -> int:
        """The scratch row id pad slots may target."""
        return self.n_clients

    @property
    def array(self) -> np.ndarray:
        """The raw ``(N + 1, width)`` matrix (checkpoint payload)."""
        return self._m

    @property
    def nbytes(self) -> int:
        return self._m.nbytes

    def column(self, name: str) -> np.ndarray:
        """One column over the REAL clients (sentinel row excluded)."""
        return self._m[:self.n_clients, COLUMNS.index(name)]

    # -- per-round updates (O(cohort), vectorized) ---------------------------

    def record_round(self, ids: np.ndarray, round_index: int) -> None:
        """Mark ``ids`` (unique, real) as this round's participants."""
        ids = np.asarray(ids, dtype=np.int64)
        self._m[ids, _PART] += 1.0
        self._m[ids, _LAST] = float(round_index)

    def bill_downloads(self, ids: np.ndarray, tags: np.ndarray,
                       nbytes: float) -> Tuple[float, int, int]:
        """Vectorized version-tagged download billing.

        Each client in ``ids`` (unique, real) fetches server version
        ``tags[i]``; a client whose cached ``version_tag`` already
        equals it is a cache *hit* (0 bytes — the stale-broadcast reuse
        the async engine's measured savings come from), anything else a
        *miss* billed ``nbytes`` and recorded.  Semantics are identical
        to ``comm.VersionCache.bill`` called per client (parity-tested);
        cost is one compare + one scatter over O(cohort) rows.

        Returns ``(billed_bytes, hits, misses)``.
        """
        ids = np.asarray(ids, dtype=np.int64)
        tags = np.asarray(tags, dtype=np.float64)
        hit = self._m[ids, _TAG] == tags
        misses = int(ids.size - hit.sum())
        self._m[ids, _TAG] = tags
        return float(misses * nbytes), int(hit.sum()), misses

    def set_cv_scale(self, ids: np.ndarray, norms: np.ndarray) -> None:
        """Record the L2 norm of each updated SCAFFOLD control-variate
        row (core/state_store.py scatter path) — the per-client drift
        signal the participation telemetry reads.  O(cohort)."""
        self._m[np.asarray(ids, dtype=np.int64), _CV] = \
            np.asarray(norms, dtype=np.float64)

    def set_ef_scale(self, ids: np.ndarray, norms: np.ndarray) -> None:
        """Record the L2 norm of each updated error-feedback residual
        row (the wire-compression bookkeeping the ``ef_scale`` column
        was reserved for) — how much compression error each client is
        still carrying.  O(cohort)."""
        self._m[np.asarray(ids, dtype=np.int64), _EF] = \
            np.asarray(norms, dtype=np.float64)

    def reset_version_tags(self) -> None:
        """Forget every client's cached version (checkpoint restore /
        external server replacement: the version history the tags
        referred to is gone)."""
        self._m[:, _TAG] = NEVER

    # -- round-jit seam -------------------------------------------------------

    def gather(self, ids: np.ndarray) -> np.ndarray:
        """The sampled rows ``(k, width)`` — what a round jit consuming
        per-client columns (SCAFFOLD, error feedback) takes as input."""
        return self._m[np.asarray(ids, dtype=np.int64)]

    def scatter(self, ids: np.ndarray, rows: np.ndarray) -> None:
        """Write updated rows back (unique ids; sentinel row allowed —
        it is scratch by contract)."""
        self._m[np.asarray(ids, dtype=np.int64)] = rows

    # -- telemetry ------------------------------------------------------------

    def participation_histogram(self, max_bucket: int = 10) -> Dict[str, int]:
        """``{participation count: n_clients}`` over real clients, counts
        above ``max_bucket`` clamped into the last bucket (``"10+"``).
        O(N) — called only on the telemetry-enabled path."""
        part = np.minimum(self.column("participation").astype(np.int64),
                          max_bucket)
        counts = np.bincount(part, minlength=max_bucket + 1)
        hist = {str(i): int(c) for i, c in enumerate(counts[:-1]) if c}
        if counts[max_bucket]:
            hist[f"{max_bucket}+"] = int(counts[max_bucket])
        return hist

    def tracked_clients(self) -> int:
        """Clients that have participated at least once."""
        return int((self.column("participation") > 0).sum())

    # -- checkpoint integration ----------------------------------------------

    def load(self, array: np.ndarray, columns: Sequence[str]) -> None:
        """Restore from a checkpointed payload.  Columns are matched by
        NAME so a checkpoint written under an older/newer schema restores
        the columns both sides know (unknown new columns keep their
        initialized defaults)."""
        array = np.asarray(array, dtype=np.float64)
        if array.shape[0] != self.n_clients + 1:
            raise ValueError(
                f"client-state size mismatch: checkpoint has "
                f"{array.shape[0] - 1} clients, trainer {self.n_clients}")
        if len(columns) != array.shape[1]:
            raise ValueError(f"column list {list(columns)} does not match "
                             f"payload width {array.shape[1]}")
        for j, name in enumerate(columns):
            if name in COLUMNS:
                self._m[:, COLUMNS.index(name)] = array[:, j]
