"""Gemma-3 4B [dense] — 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt].  34L, d_model 2560, 8 heads (GQA kv=4),
d_ff 10240, vocab 262144, local window 1024.
Pattern period (5x local, 1x global) x 5 + 4 local remainder layers.
A copy of ``repro.configs.gemma3_4b``."""

from repro_torch.configs.base import LayerSpec, ModelConfig

_L = LayerSpec("local_attn")
_G = LayerSpec("attn")

CONFIG = ModelConfig(
    name="gemma3-4b",
    arch_type="dense",
    source="hf:google/gemma-3-1b-pt",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10_240,
    vocab_size=262_144,
    pattern=(_L, _L, _L, _L, _L, _G),
    window=1024,
    rope_theta=1_000_000.0,
    use_qk_norm=True,
    param_dtype="bfloat16",
    attn_shard="replicate",   # 8 heads < model axis (16)
)


def reduced() -> ModelConfig:
    return CONFIG.with_overrides(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512, window=16, exit_layer=2,
        pattern=(_L, _G),
        param_dtype="float32", compute_dtype="float32")
