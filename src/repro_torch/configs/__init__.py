"""Architecture registry of the port.

The port's counterpart of ``repro.configs.get_config`` / ``get_reduced``.
The zoo is complete: every architecture the reference knows is ported
(RecurrentGemma-2B, Gemma-2 2B, the dense Gemma-3 4B, Minitron-8B and
StarCoder2-15B, the Mixture-of-Experts Qwen1.5-MoE-A2.7B and Kimi K2,
xLSTM-1.3B, the VLM LLaVA-NeXT 34B and the four-codebook MusicGen-Large),
so :data:`PORTED` is :data:`ARCH_NAMES`.  An unknown name raises
``KeyError``, as in the reference.

:func:`input_specs` gives every input a step function of
``launch/steps.py`` takes for one (config, input shape) as ``meta``
tensors: shapes and dtypes, nothing allocated (the reference's
``jax.ShapeDtypeStruct`` stand-ins).
"""

from __future__ import annotations

import importlib
from typing import Dict, Optional

import torch

from repro_torch.configs.base import (  # noqa: F401 (the reference's names)
    DECODE_32K, INPUT_SHAPES, LONG_500K, PREFILL_32K, TRAIN_4K, InputShape,
    ModelConfig)

# the reference's registry, in its order
_MODULES = {
    "recurrentgemma-2b": "recurrentgemma_2b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "starcoder2-15b": "starcoder2_15b",
    "gemma2-2b": "gemma2_2b",
    "xlstm-1.3b": "xlstm_1_3b",
    "llava-next-34b": "llava_next_34b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "gemma3-4b": "gemma3_4b",
    "musicgen-large": "musicgen_large",
    "minitron-8b": "minitron_8b",
}

ARCH_NAMES = tuple(_MODULES)
PORTED = ARCH_NAMES

# Archs whose paper config is natively sub-quadratic (bounded state or a
# local window): they run long_500k as configured; the rest take the
# sliding-window long-context variant (``cfg.longctx_window``).
NATIVE_LONGCTX = ("recurrentgemma-2b", "xlstm-1.3b", "gemma2-2b", "gemma3-4b")


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _module(name).reduced()


def needs_longctx_variant(cfg: ModelConfig, shape: InputShape) -> bool:
    return shape.name == "long_500k" and cfg.name not in NATIVE_LONGCTX


def input_specs(cfg: ModelConfig, shape: InputShape,
                batch_override: Optional[int] = None
                ) -> Dict[str, torch.Tensor]:
    """``meta`` tensors for every input a step function takes at
    ``shape``: ``tokens`` int32 ``(b, s + 1)`` for train, ``(b, s)`` for
    prefill, ``(b, 1)`` for decode, with a trailing codebook axis for a
    multi-codebook config; outside decode a config with a frontend also
    gets ``extra_embeds`` ``(b, n_tokens, d_in)`` in the compute dtype,
    and its token part is shortened by ``n_tokens``."""
    b = batch_override or shape.global_batch
    s = shape.seq_len
    tok_shape = (b, s + 1) if shape.kind == "train" else (b, s)
    if shape.kind == "decode":
        tok_shape = (b, 1)
    if cfg.n_codebooks > 1:
        tok_shape = tok_shape + (cfg.n_codebooks,)
    meta = lambda shp, dtype: torch.empty(shp, dtype=dtype, device="meta")
    specs = {"tokens": meta(tok_shape, torch.int32)}
    if cfg.frontend is not None and shape.kind != "decode":
        fe = cfg.frontend
        specs["extra_embeds"] = meta((b, fe.n_tokens, fe.d_in),
                                     cfg.torch_compute_dtype())
        specs["tokens"] = meta((b, tok_shape[1] - fe.n_tokens)
                               + tok_shape[2:], torch.int32)
    return specs
