"""Host-side cohort sampling: the paper's uniform 10% draw, at any scale.

The port's own copy of ``repro.core.sampling`` (numpy only): both
packages must draw identical plans from the same ``(seed, round)``, which
``tests/test_torch_host.py`` holds them to.

FedHeN samples participants *uniformly* — each round activates
``participation * n_devices`` clients drawn without replacement from the
whole population, whatever their architecture (paper §3).  The original
trainer approximated that with *stratified* per-population draws (k_s
simple + k_c complex every round — the expectation of the uniform draw,
chosen so jit shapes stay static).  This module supplies both modes
behind one object, and fixes two structural problems at once:

* **Purity.**  A :class:`CohortSampler` draw is a pure function of
  ``(seed, round_index)`` (each round gets its own
  ``np.random.SeedSequence([seed, round])`` stream).  The old trainer
  consumed a single sequential ``default_rng(seed)`` stream that was
  never checkpointed, so a resumed run silently replayed round 0's
  cohort sequence at round R.  A pure sampler needs no residual state:
  restoring the round counter restores the cohort sequence exactly
  (``state_dict`` carries only the identity facts the checkpoint
  validates against).

* **Scale.**  Draws cost O(cohort), not O(population): ids are drawn by
  vectorized rejection sampling (uniqueness via order-preserving
  dedupe), so a 10^6-client registry samples as fast as a 10^2 one —
  the benchmark gate in ``benchmarks/client_scale.py``.

**Uniform super-cohort mode** (``uniform=True``) recovers the paper's
exact protocol under static shapes: one draw of
``k_super = ceil(participation * n_devices)`` clients over the whole
population, routed into fixed per-architecture slot blocks of capacity
``min(k_super, population size)``.  The realized per-arch composition is
random, so unused slots are *padded* by wrapping already-drawn ids with
``real=False`` — the existing weight-0 validity path zero-weights them
in the fold and the loss normalizes by the realized count, so padding
can never bias the aggregate (exactly the chunk-padding contract in
``core/federated.py``).  At ``participation=1.0`` the two modes draw the
same (sorted, canonical) cohort, which is what the uniform-vs-stratified
bit-parity test pins.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

# SeedSequence entropy words must be non-negative ints < 2**64
_SEED_MASK = (1 << 64) - 1


def round_rng(seed: int, round_index: int) -> np.random.Generator:
    """The round's private RNG stream: pure in ``(seed, round_index)``.

    Streams of different rounds are statistically independent
    (SeedSequence hashes the entropy tuple), and no cross-round state
    exists to checkpoint — the resume bugfix is this function."""
    if round_index < 0:
        raise ValueError(f"round_index must be >= 0, got {round_index}")
    return np.random.default_rng(
        np.random.SeedSequence([seed & _SEED_MASK, round_index]))


def draw_without_replacement(rng: np.random.Generator, n: int,
                             k: int) -> np.ndarray:
    """``k`` distinct ids uniform over ``[0, n)``, sorted, in O(k) host
    time for sparse draws (k << n).

    Dense draws (k within 4x of n) fall back to a partial Fisher-Yates
    (``Generator.choice`` without replacement) — O(n), but O(n) = O(4k)
    there.  Sparse draws use batched rejection sampling: draw a batch of
    candidates, keep the first-seen occurrence of each (order-preserving
    dedupe — taking the first ``k`` of a *sorted* unique would bias
    toward small ids), and repeat on the shortfall.  Sequential
    rejection of repeats is exactly uniform sampling without
    replacement, so the result is unbiased (chi-square-tested).
    """
    if not 0 <= k <= n:
        raise ValueError(f"need 0 <= k <= n, got k={k}, n={n}")
    if k == n:
        return np.arange(n, dtype=np.int64)
    if 4 * k >= n:
        return np.sort(rng.choice(n, size=k, replace=False).astype(np.int64))
    chosen = np.empty((0,), dtype=np.int64)
    while chosen.size < k:
        need = k - chosen.size
        draw = rng.integers(0, n, size=2 * need + 8, dtype=np.int64)
        draw = draw[~np.isin(draw, chosen)]
        # order-preserving unique: first occurrence in draw order
        _, first = np.unique(draw, return_index=True)
        fresh = draw[np.sort(first)][:need]
        chosen = np.concatenate([chosen, fresh])
    return np.sort(chosen)


def _pad_to(ids: np.ndarray, capacity: int, fallback: int) -> np.ndarray:
    """Pad ``ids`` up to ``capacity`` slots by wrapping the drawn ids
    (``fallback`` when the draw is empty).  Pad slots carry real client
    data but fold at weight 0 — they exist only to keep shapes static."""
    if ids.size >= capacity:
        return ids[:capacity]
    if ids.size == 0:
        return np.full((capacity,), fallback, dtype=np.int64)
    reps = -(-capacity // ids.size)
    return np.tile(ids, reps)[:capacity]


@dataclasses.dataclass(frozen=True)
class CohortPlan:
    """One round's resolved cohort: absolute client ids routed into the
    two populations' static slot blocks, plus the per-slot reality masks
    the weight-0 validity path consumes.

    ``simple_ids`` / ``complex_ids`` have the sampler's static
    capacities; ``*_real`` marks slots holding a distinct sampled client
    (pad slots wrap a real id and must fold at weight 0)."""
    round_index: int
    simple_ids: np.ndarray
    complex_ids: np.ndarray
    simple_real: np.ndarray
    complex_real: np.ndarray

    @property
    def n_real_simple(self) -> int:
        return int(self.simple_real.sum())

    @property
    def n_real_complex(self) -> int:
        return int(self.complex_real.sum())

    @property
    def all_real(self) -> bool:
        return bool(self.simple_real.all() and self.complex_real.all())

    def real_ids(self) -> np.ndarray:
        """The round's distinct sampled clients (both populations)."""
        return np.concatenate([self.simple_ids[self.simple_real],
                               self.complex_ids[self.complex_real]])


class CohortSampler:
    """Draws one :class:`CohortPlan` per round, pure in (seed, round).

    ``uniform=False`` (stratified, the pre-existing approximation):
    ``k_s = max(round(p * n_simple), 1)`` simple ids plus
    ``k_c = max(round(p * n_complex), 1)`` complex ids, drawn
    independently per population — every slot real, every round.  The
    capacities are exactly the old trainer's, so the stratified round
    program is unchanged.

    ``uniform=True`` (the paper's protocol): ONE draw of
    ``k_super = max(ceil(p * n_devices), 1)`` ids over the whole
    population, split by architecture into slot blocks of capacity
    ``cap_simple = min(k_super, n_simple)`` /
    ``cap_complex = min(k_super, n_complex)``; unfilled slots wrap drawn
    ids with ``real=False``.  Ids are canonically sorted per population
    in both modes (the aggregation is weight-symmetric, so order is
    free — sorting makes the two modes comparable and the gather
    cache-friendly).
    """

    def __init__(self, *, n_devices: int, n_simple: int,
                 participation: float, seed: int, uniform: bool = False):
        if not 0 < n_simple < n_devices:
            raise ValueError(f"need 0 < n_simple < n_devices, got "
                             f"{n_simple} / {n_devices}")
        if not 0.0 < participation <= 1.0:
            raise ValueError(f"participation must be in (0, 1], got "
                             f"{participation}")
        self.n_devices = int(n_devices)
        self.n_simple = int(n_simple)
        self.n_complex = self.n_devices - self.n_simple
        self.participation = float(participation)
        self.seed = int(seed)
        self.uniform = bool(uniform)
        if uniform:
            self.k_super = max(int(np.ceil(participation * n_devices)), 1)
            self.cap_simple = min(self.k_super, self.n_simple)
            self.cap_complex = min(self.k_super, self.n_complex)
        else:
            self.k_super = 0
            self.cap_simple = max(int(round(participation * n_simple)), 1)
            self.cap_complex = max(int(round(participation
                                             * self.n_complex)), 1)

    def plan(self, round_index: int) -> CohortPlan:
        """The round's cohort — same ``(seed, round_index)``, same plan,
        regardless of call order or process restarts."""
        rng = round_rng(self.seed, round_index)
        if not self.uniform:
            simple = draw_without_replacement(rng, self.n_simple,
                                              self.cap_simple)
            complex_ = self.n_simple + draw_without_replacement(
                rng, self.n_complex, self.cap_complex)
            ones_s = np.ones((self.cap_simple,), dtype=bool)
            ones_c = np.ones((self.cap_complex,), dtype=bool)
            return CohortPlan(round_index, simple, complex_, ones_s, ones_c)
        ids = draw_without_replacement(rng, self.n_devices, self.k_super)
        simple = ids[ids < self.n_simple]
        complex_ = ids[ids >= self.n_simple]
        real_s = np.arange(self.cap_simple) < simple.size
        real_c = np.arange(self.cap_complex) < complex_.size
        return CohortPlan(
            round_index,
            _pad_to(simple, self.cap_simple, fallback=0),
            _pad_to(complex_, self.cap_complex, fallback=self.n_simple),
            real_s, real_c)

    # -- checkpoint integration ---------------------------------------------

    def state_dict(self) -> Dict:
        """The sampler's identity facts for checkpoint meta.  A pure
        sampler has no mutable state — these exist so a resume can
        VALIDATE that the restored run re-creates the same cohort
        sequence (same seed, mode, and geometry)."""
        return {"seed": self.seed, "uniform": self.uniform,
                "participation": self.participation,
                "n_devices": self.n_devices, "n_simple": self.n_simple}

    def validate_state(self, state: Optional[Dict]) -> None:
        """Raise if a checkpoint's sampler facts disagree with this
        sampler (a silent mismatch would change the cohort sequence
        mid-run — the exact bug class the pure sampler retires)."""
        if not state:
            return     # pre-sampler checkpoint: nothing to validate
        mine = self.state_dict()
        diffs = {k: (state[k], mine[k]) for k in mine
                 if k in state and state[k] != mine[k]}
        if diffs:
            raise ValueError(f"checkpoint sampler state mismatch: {diffs}")
