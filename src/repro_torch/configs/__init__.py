"""Architecture registry of the port.

The port's counterpart of ``repro.configs.get_config`` / ``get_reduced``.
The zoo is complete: every architecture the reference knows is ported
(RecurrentGemma-2B, Gemma-2 2B, the dense Gemma-3 4B, Minitron-8B and
StarCoder2-15B, the Mixture-of-Experts Qwen1.5-MoE-A2.7B and Kimi K2,
xLSTM-1.3B, the VLM LLaVA-NeXT 34B and the four-codebook MusicGen-Large),
so :data:`PORTED` is :data:`ARCH_NAMES`.  An unknown name raises
``KeyError``, as in the reference.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

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


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _module(name).reduced()
