"""Configuration dataclasses: the model zoo's and the federated protocol's.

The port's own copies of ``repro.configs.base``'s ``LayerSpec``,
``MoEConfig``, ``StubFrontend``, ``ModelConfig`` and ``FedConfig``: the
same fields, defaults, derived properties and ``validate()`` rules.  A
model's stack is ``n_periods`` repetitions of its ``pattern`` plus
``n_remainder`` tail layers; the FedHeN simple model is the depth prefix
``blocks[:resolved_exit_layer]`` with its own exit head.  The dtype names
map to torch dtypes through ``torch_param_dtype`` / ``torch_compute_dtype``
(the reference's ``jnp_*``).  ``validate()`` rejects what the
reference's rejects, with the same ``ValueError`` rules.  ``InputShape``
and ``INPUT_SHAPES`` are the reference's four assigned input shapes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch

from repro_torch.core.aggregate import ALGORITHMS
from repro_torch.core.comm import WireSpec

# ---------------------------------------------------------------------------
# Layer kinds
# ---------------------------------------------------------------------------

ATTN_GLOBAL = "attn"          # full causal attention
ATTN_LOCAL = "local_attn"     # sliding-window causal attention
RGLRU = "rglru"               # Griffin/RecurrentGemma real-gated LRU block
MLSTM = "mlstm"               # xLSTM matrix-memory block
SLSTM = "slstm"               # xLSTM scalar-memory block

MIXER_KINDS = (ATTN_GLOBAL, ATTN_LOCAL, RGLRU, MLSTM, SLSTM)

MLP_DENSE = "dense"
MLP_MOE = "moe"
MLP_NONE = "none"             # block has no separate MLP (xLSTM style)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name."""
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r} (expected one of "
                         f"{sorted(_DTYPES)})")
    return _DTYPES[name]


@dataclass(frozen=True)
class LayerSpec:
    """One position in the repeating layer pattern."""

    mixer: str = ATTN_GLOBAL
    mlp: str = MLP_DENSE

    def __post_init__(self):
        if self.mixer not in MIXER_KINDS:
            raise ValueError(f"unknown mixer kind {self.mixer!r}")
        if self.mlp not in (MLP_DENSE, MLP_MOE, MLP_NONE):
            raise ValueError(f"unknown mlp kind {self.mlp!r}")


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int            # routed experts
    top_k: int
    n_shared: int = 0         # always-on shared experts
    d_expert: int = 0         # per-expert FFN hidden dim
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2
    pad_to: int = 0           # pad the expert axis to this size (0 = off)


@dataclass(frozen=True)
class StubFrontend:
    """Modality frontend stub: precomputed ``(batch, n_tokens, d_in)``
    embeddings; the backbone owns only the projector."""

    kind: str                 # "vision" | "audio_conditioning"
    n_tokens: int
    d_in: int


@dataclass(frozen=True)
class ModelConfig:
    """One architecture of the zoo.  See ``repro.configs.base.ModelConfig``
    for each field's meaning."""

    # -- identity ----------------------------------------------------------
    name: str = "model"
    arch_type: str = "dense"  # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""          # citation for the config numbers

    # -- dimensions --------------------------------------------------------
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0         # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 1024

    # -- layer pattern -----------------------------------------------------
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    window: int = 4096        # sliding window for local attention layers
    rope_theta: float = 10000.0
    attn_logit_softcap: float = 0.0   # gemma-2 style; 0 disables
    final_logit_softcap: float = 0.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    use_qk_norm: bool = False
    d_rnn: int = 0            # RG-LRU width (0 -> d_model)
    lru_temporal_width: int = 4

    # -- MoE / modality ----------------------------------------------------
    moe: Optional[MoEConfig] = None
    mlp_glu: bool = True      # gated (3-matrix) vs plain (2-matrix) MLP
    n_codebooks: int = 1
    frontend: Optional[StubFrontend] = None

    # -- xLSTM -------------------------------------------------------------
    mlstm_proj_factor: float = 2.0
    slstm_ff_factor: float = 4.0 / 3.0
    mlstm_chunk: int = 64

    # -- FedHeN ------------------------------------------------------------
    exit_layer: int = 0       # K: simple subnet = blocks[:K]; 0 -> n_layers//2

    # -- numerics ----------------------------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # -- sharding hints (the reference's mesh; one card here) ----------------
    attn_shard: str = "auto"
    shard_experts_2d: bool = False

    # -- long-context variant ------------------------------------------------
    longctx_window: int = 8192

    def __post_init__(self):
        if self.n_heads % self.n_kv_heads != 0:
            raise ValueError("n_heads must be divisible by n_kv_heads")

    # Derived quantities -------------------------------------------------

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def resolved_d_rnn(self) -> int:
        return self.d_rnn if self.d_rnn else self.d_model

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def n_periods(self) -> int:
        return self.n_layers // self.period

    @property
    def n_remainder(self) -> int:
        return self.n_layers % self.period

    @property
    def resolved_exit_layer(self) -> int:
        """FedHeN K, rounded down to a period boundary (>= one period)."""
        k = self.exit_layer if self.exit_layer else self.n_layers // 2
        k = (k // self.period) * self.period
        return max(k, self.period)

    @property
    def exit_period(self) -> int:
        return self.resolved_exit_layer // self.period

    def layer_spec(self, idx: int) -> LayerSpec:
        return self.pattern[idx % self.period]

    def torch_param_dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    def torch_compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    # Parameter counting ---------------------------------------------------

    def param_count(self) -> int:
        """Analytical parameter count of the complex model."""
        d, v = self.d_model, self.vocab_size
        total = v * d * self.n_codebooks          # embeddings
        if not self.tie_embeddings:
            total += v * d * self.n_codebooks
        if self.frontend is not None:
            total += self.frontend.d_in * d       # projector
        for i in range(self.n_layers):
            total += self._layer_params(self.layer_spec(i))
        total += d                                 # final norm
        total += d                                 # exit norm (FedHeN head)
        return total

    def _layer_params(self, spec: LayerSpec) -> int:
        d = self.d_model
        hd = self.resolved_head_dim
        n = 0
        if spec.mixer in (ATTN_GLOBAL, ATTN_LOCAL):
            n += d * self.n_heads * hd             # Wq
            n += 2 * d * self.n_kv_heads * hd      # Wk, Wv
            n += self.n_heads * hd * d             # Wo
        elif spec.mixer == RGLRU:
            dr = self.resolved_d_rnn
            n += 2 * d * dr + dr * d               # in/gate/out proj
            n += dr * self.lru_temporal_width      # temporal conv
            n += 3 * dr                            # the reference's count; the
            # block holds five (w_r, b_r, w_i, b_i, lam)
        elif spec.mixer == MLSTM:
            di = int(self.d_model * self.mlstm_proj_factor)
            n += 2 * d * di                        # up + gate proj
            n += 3 * di * (di // self.n_heads)     # block-diag q, k, v
            n += di * 2 * self.n_heads             # i, f gate projections
            n += di * d                            # down proj
        elif spec.mixer == SLSTM:
            nh, dh = self.n_heads, d // self.n_heads
            n += 4 * d * d                         # i, f, z, o input projections
            n += 4 * nh * dh * dh                  # recurrent (block-diag)
            dff = int(d * self.slstm_ff_factor)
            n += 2 * d * dff                       # post FFN
        n += 2 * d                                 # pre norms (mixer + mlp)
        mats = 3 if self.mlp_glu else 2            # (gate,) up, down
        if spec.mlp == MLP_DENSE:
            n += mats * d * self.d_ff
        elif spec.mlp == MLP_MOE:
            m = self.moe
            de = m.d_expert or self.d_ff
            n += d * m.n_experts                   # router
            n += mats * d * de * (m.n_experts + m.n_shared)
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        de = m.d_expert or self.d_ff
        n_moe_layers = sum(1 for i in range(self.n_layers)
                           if self.layer_spec(i).mlp == MLP_MOE)
        mats = 3 if self.mlp_glu else 2
        return self.param_count() - n_moe_layers * mats * self.d_model * de \
            * (m.n_experts - m.top_k)

    def simple_param_count(self) -> int:
        """Analytical parameter count of the FedHeN simple subnet."""
        d, v = self.d_model, self.vocab_size
        total = v * d * self.n_codebooks
        if self.frontend is not None:
            total += self.frontend.d_in * d
        for i in range(self.resolved_exit_layer):
            total += self._layer_params(self.layer_spec(i))
        total += d                                 # exit norm
        return total

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes (the reference's assigned four)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

INPUT_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                    LONG_500K)}


# ---------------------------------------------------------------------------
# Federated experiment config (paper §3 + Appendix A)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FedConfig:
    """Hyper-parameters of the FedHeN experimental protocol.

    See ``repro.configs.base.FedConfig`` for each field's meaning."""

    n_devices: int = 100           # total federated clients
    n_simple: int = 50             # first 50 simple, rest complex (paper)
    participation: float = 0.10    # 10% active per round
    sample_uniform: bool = False   # True: the paper's uniform cohort draw
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
    agg_engine: str = "flat"       # or "tree": one K4 launch per leaf
    # the reference's kernel tile width; here it only rounds the flat
    # layout's length, so n_flat matches the reference's
    agg_block_n: int = 2048
    agg_stream_dtype: str = "float32"   # or "bfloat16"; accumulation is f32
    agg_memory_budget_mb: float = 512.0
    comm_dtype: str = "float32"    # float32 | bfloat16 | int8
    quant_block: int = 128
    topk_frac: float = 1.0
    stochastic_rounding: bool = False
    error_feedback: bool = False
    async_lag: int = 0             # chunk folds of broadcast staleness
    async_staleness: str = "poly"
    async_decay: float = 0.5
    variance_reduction: str = "none"   # or "scaffold" (option II)
    state_store_backend: str = "auto"

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        """Single entry point for every config-rejection rule (the
        reference's ``ValueError`` rules)."""
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
