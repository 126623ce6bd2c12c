"""Federated experiment config (paper §3 + Appendix A).

The port's own copy of ``repro.configs.base.FedConfig``: the same fields,
defaults and ``validate()`` rules.  Knobs this slice of the port does not
implement yet are accepted as fields (so configs stay interchangeable) but
rejected by ``validate()`` with ``NotImplementedError`` naming the knob.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union

from repro_torch.core.aggregate import ALGORITHMS
from repro_torch.core.comm import WireSpec


@dataclass(frozen=True)
class FedConfig:
    """Hyper-parameters of the FedHeN experimental protocol.

    See ``repro.configs.base.FedConfig`` for each field's meaning."""

    n_devices: int = 100           # total federated clients
    n_simple: int = 50             # first 50 simple, rest complex (paper)
    participation: float = 0.10    # 10% active per round
    sample_uniform: bool = False   # not ported yet
    rounds: int = 1000             # T
    local_epochs: int = 5          # E
    lr: float = 0.1                # eta
    clip_norm: float = 10.0        # gradient clipping (Appendix A)
    batch_size: int = 50
    dirichlet_alpha: float = 0.3   # non-IID split concentration
    iid: bool = True
    algorithm: str = "fedhen"      # fedhen | noside | decouple
    seed: int = 0
    skip_nan_devices: bool = True  # Appendix A: drop NaN devices for the round
    prox_mu: float = 0.0           # FedProx mu/2 ||w - w_server||^2; 0 = off
    # clients per fold chunk (per population); 0 = whole population,
    # "auto" = derived from agg_memory_budget_mb
    cohort_chunk: Union[int, str] = 0
    agg_engine: str = "flat"       # "tree": not ported yet
    # the reference's kernel tile width; here it only rounds the flat
    # layout's length, so n_flat matches the reference's
    agg_block_n: int = 2048
    agg_stream_dtype: str = "float32"   # or "bfloat16"; accumulation is f32
    agg_memory_budget_mb: float = 512.0
    comm_dtype: str = "float32"    # only the identity f32 wire is ported
    quant_block: int = 128
    topk_frac: float = 1.0
    stochastic_rounding: bool = False
    error_feedback: bool = False
    async_lag: int = 0
    async_staleness: str = "poly"
    async_decay: float = 0.5
    variance_reduction: str = "none"
    state_store_backend: str = "auto"

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        """Single entry point for every config-rejection rule: the
        reference's ``ValueError`` rules first, then ``NotImplementedError``
        for each knob this slice does not port."""
        if self.algorithm not in ALGORITHMS:
            raise ValueError(f"unknown algorithm {self.algorithm!r} "
                             f"(expected one of {ALGORITHMS})")
        if self.agg_engine not in ("flat", "tree"):
            raise ValueError(f"unknown agg_engine {self.agg_engine!r}")
        if self.agg_block_n <= 0 or self.agg_block_n % 128:
            raise ValueError("agg_block_n must be a positive multiple of 128")
        if self.agg_stream_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"agg_stream_dtype must be float32 or "
                             f"bfloat16, got {self.agg_stream_dtype!r}")
        if isinstance(self.cohort_chunk, str) and self.cohort_chunk != "auto":
            raise ValueError(f"cohort_chunk must be an int or 'auto', got "
                             f"{self.cohort_chunk!r}")
        spec = WireSpec(self.comm_dtype, self.quant_block,
                        topk_frac=self.topk_frac,
                        stochastic=self.stochastic_rounding,
                        error_feedback=self.error_feedback)
        if self.comm_dtype == "int8" and self.agg_engine != "flat":
            raise ValueError("comm_dtype=int8 requires agg_engine='flat' "
                             "(the dequantizing fold is a flat-buffer op)")
        if spec.uses_deltas and self.agg_engine != "flat":
            raise ValueError("compressed uploads (topk_frac < 1, "
                             "stochastic_rounding or error_feedback) require "
                             "agg_engine='flat' (the delta fold is a "
                             "flat-buffer op)")
        if self.async_lag < 0:
            raise ValueError("async_lag must be >= 0 (folds of broadcast "
                             f"staleness), got {self.async_lag}")
        if self.async_staleness not in ("poly", "none"):
            raise ValueError(f"async_staleness must be 'poly' or 'none', "
                             f"got {self.async_staleness!r}")
        if self.async_decay < 0:
            raise ValueError(f"async_decay must be >= 0, "
                             f"got {self.async_decay}")
        if self.variance_reduction not in ("none", "scaffold"):
            raise ValueError(f"variance_reduction must be 'none' or "
                             f"'scaffold', got {self.variance_reduction!r}")
        if self.state_store_backend not in ("auto", "device", "host", "mmap"):
            raise ValueError(f"state_store_backend must be one of "
                             f"auto/device/host/mmap, "
                             f"got {self.state_store_backend!r}")
        if self.variance_reduction == "scaffold" and self.lr <= 0:
            raise ValueError("variance_reduction='scaffold' requires lr > 0 "
                             "(control-variate deltas divide by K*lr)")
        unported = {
            "comm_dtype": self.comm_dtype != "float32",
            "topk_frac": self.topk_frac < 1.0,
            "stochastic_rounding": self.stochastic_rounding,
            "error_feedback": self.error_feedback,
            "async_lag": self.async_lag > 0,
            "variance_reduction": self.variance_reduction == "scaffold",
            "agg_engine": self.agg_engine == "tree",
            "sample_uniform": self.sample_uniform,
        }
        for knob, on in unported.items():
            if on:
                raise NotImplementedError(
                    f"{knob}={getattr(self, knob)!r} is not ported to "
                    f"repro_torch yet (the JAX package implements it)")
