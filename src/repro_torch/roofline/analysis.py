"""Roofline terms of one step: the port of ``repro.roofline.analysis``.

:func:`analytic_hbm`, :func:`model_flops` and :class:`RooflineRecord`'s
terms are the reference's arithmetic, unchanged, over the H100's constants
(``roofline/hw.py``):

    compute    = flops_per_chip / PEAK_FLOPS_BF16
    memory     = hbm_analytic_per_chip / HBM_BW
    collective = coll_bytes_per_chip / NVLINK_BW

:func:`make_record` takes the counters of a walk of the step
(``roofline/torch_walk.py``, over ``meta`` tensors in the dry-runs) where
the reference's takes a compiled executable.  Three fields therefore mean
something else, and the record says so in ``notes``:

* ``flops_per_chip`` and ``bytes_per_chip`` are the walk's global counts
  divided evenly by the chips.  The reference counts the post-SPMD
  per-device module, replication waste included; the port cannot count
  that.
* ``coll_bytes_per_chip`` is ``None`` for a walk of the whole step on one
  process: it issues no collective, so there is none to count, and
  ``bottleneck`` and ``roofline_time`` are taken over compute and memory
  only.
* ``peak_memory_per_chip`` is ``param_bytes + cache_bytes + batch bytes``
  per chip: a ``meta`` run has no allocator to report a peak.

A walk of one rank of a live mesh (``per_chip=True``: the dry-runs of the
configs that run over a model axis, on ``meta`` DTensors under a fake
process group of the mesh's size) counts that rank's own work and its
collectives, so ``flops_per_chip`` and ``bytes_per_chip`` are the walk's
counts as they are, and ``coll_bytes_per_chip`` is the sum of
:func:`collective_bytes`: the result bytes a device receives a step, by
collective type, the reference's convention.  ``bottleneck`` then takes
the collective term at ``hw.NVLINK_BW``.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Dict, Optional

from repro_torch.roofline import hw

NOTES = {
    "flops_per_chip": "the walk's global flops / chips (an even split; the "
                      "reference's post-SPMD count includes replication "
                      "waste, which the port cannot count)",
    "bytes_per_chip": "the walk's global HBM bytes / chips (the same even "
                      "split)",
    "coll_bytes_per_chip": "None: a walk of the whole step on one process "
                           "issues no collective; bottleneck over compute "
                           "and memory only",
    "peak_memory_per_chip": "param + cache + batch bytes per chip (a meta "
                            "run has no allocator)",
}
# a walk of one rank of a live mesh (make_record(per_chip=True))
NOTES_PER_CHIP = {
    "flops_per_chip": "the walk of rank 0 of a fake process group of the "
                      "mesh's size, on meta DTensors: that rank's local "
                      "ops (its shards; the embedding lookup at the global "
                      "batch)",
    "bytes_per_chip": "the same walk's HBM bytes",
    "coll_bytes_per_chip": "the collectives' result bytes on that rank "
                           "(analysis.collective_bytes), at NVLINK_BW",
    "peak_memory_per_chip": NOTES["peak_memory_per_chip"],
}


def collective_bytes(walk: Dict) -> Dict:
    """Per-collective-type result bytes on one device (the reference's
    ``collective_bytes`` of its per-device HLO), from a walk's counters,
    with each type's count under ``_counts``."""
    out = dict(walk["collective_bytes"])
    out["_counts"] = dict(walk["collective_counts"])
    return out


@dataclass
class RooflineRecord:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float          # per device, per step
    bytes_per_chip: float
    coll_bytes_per_chip: Optional[float]
    coll_breakdown: Dict[str, int] = field(default_factory=dict)
    peak_memory_per_chip: float = 0.0
    argument_bytes_per_chip: float = 0.0
    model_flops: float = 0.0       # analytical 6ND / 2ND (global)
    longctx_variant: bool = False
    param_bytes_per_chip: float = 0.0
    cache_bytes_per_chip: float = 0.0
    hbm_analytic_per_chip: float = 0.0   # traffic model (see analytic_hbm)
    notes: Dict[str, str] = field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / hw.PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        """Analytic HBM traffic (weights + activations + caches) / HBM bw;
        the walk's byte count (``bytes_per_chip``) is kept beside it."""
        return self.hbm_analytic_per_chip / hw.HBM_BW

    @property
    def t_collective(self) -> Optional[float]:
        if self.coll_bytes_per_chip is None:
            return None
        return self.coll_bytes_per_chip / hw.NVLINK_BW

    def _terms(self) -> Dict[str, float]:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return {k: v for k, v in terms.items() if v is not None}

    @property
    def bottleneck(self) -> str:
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (flops_per_chip x chips)."""
        total = self.flops_per_chip * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_time(self) -> float:
        return max(self._terms().values())

    def to_dict(self) -> Dict:
        d = asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, bottleneck=self.bottleneck,
                 useful_flops_ratio=self.useful_flops_ratio)
        return d


def analytic_hbm(cfg, shape, param_bytes_chip: float,
                 cache_bytes_chip: float, chips: int) -> float:
    """Per-chip HBM traffic model for one step (the reference's).

    train:  weights are read 3x (fwd, remat re-fwd, bwd) and written once
            with gradients read+written once -> ~6x param bytes; plus saved
            period activations written+read.
    prefill: weights 1x + cache write + layer activations streamed 2x.
    decode:  weights 1x + cache read + write (the classic decode bound).
    """
    act_bytes = 2  # bf16
    data_shards = max(chips // 16, 1)  # data(+pod) axes of the mesh
    if shape.kind == "train":
        tokens_chip = shape.global_batch * shape.seq_len / data_shards
        saved = cfg.n_periods * tokens_chip * cfg.d_model * act_bytes
        return 6.0 * param_bytes_chip + 2.0 * saved
    if shape.kind == "prefill":
        tokens_chip = shape.global_batch * shape.seq_len / data_shards
        stream = 2.0 * cfg.n_layers * tokens_chip * cfg.d_model * act_bytes
        return param_bytes_chip + cache_bytes_chip + stream
    # decode: one token; MoE reads only the experts the batch touches
    weight_read = param_bytes_chip
    if cfg.moe is not None and cfg.moe.n_experts > cfg.moe.top_k:
        e, k = cfg.moe.n_experts, cfg.moe.top_k
        inactive_frac = 1.0 - cfg.active_param_count() / cfg.param_count()
        expert_frac = min(inactive_frac * e / (e - k), 0.99)
        touched = min(1.0, shape.global_batch * k / e)
        weight_read = param_bytes_chip * (
            (1.0 - expert_frac) + expert_frac * touched)
    return weight_read + 2.0 * cache_bytes_chip


def model_flops(cfg, shape) -> float:
    """Analytical 'useful' FLOPs per step (global, all chips).

    train: 6 * N_active * tokens ; prefill: 2 * N_active * tokens ;
    decode: 2 * N_active * batch (one token per sequence).
    """
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


def make_record(*, arch: str, shape, mesh_name: str, chips: int,
                walk: Dict, cfg, longctx_variant: bool = False,
                param_bytes_chip: float = 0.0,
                cache_bytes_chip: float = 0.0,
                batch_bytes_chip: float = 0.0,
                per_chip: bool = False) -> RooflineRecord:
    """The record of one step from its walk's counters (module
    docstring): of the whole step, split evenly over ``chips``, or with
    ``per_chip`` of one rank of a live mesh."""
    hbm = analytic_hbm(cfg, shape, param_bytes_chip, cache_bytes_chip, chips)
    split = 1 if per_chip else chips
    coll = None
    if per_chip:
        coll = float(sum(v for k, v in collective_bytes(walk).items()
                         if k != "_counts"))
    return RooflineRecord(
        param_bytes_per_chip=param_bytes_chip,
        cache_bytes_per_chip=cache_bytes_chip,
        hbm_analytic_per_chip=hbm,
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        flops_per_chip=float(walk["flops"]) / split,
        bytes_per_chip=float(walk["hbm_bytes"]) / split,
        coll_bytes_per_chip=coll,
        coll_breakdown={**walk["collective_bytes"],
                        "counts": walk["collective_counts"],
                        "kernels": walk.get("kernels", {})},
        peak_memory_per_chip=float(param_bytes_chip + cache_bytes_chip
                                   + batch_bytes_chip),
        argument_bytes_per_chip=float(param_bytes_chip + batch_bytes_chip),
        model_flops=model_flops(cfg, shape),
        longctx_variant=longctx_variant,
        notes=dict(NOTES_PER_CHIP if per_chip else NOTES))
