"""Qwen1.5-MoE-A2.7B [moe] — 4 shared + 60 routed experts, top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B].  24L, d_model 2048, 16 heads (kv=16),
per-expert d_ff 1408, vocab 151936.
A copy of ``repro.configs.qwen2_moe_a2_7b``."""

from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    arch_type="moe",
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151_936,
    pattern=(LayerSpec("attn", "moe"),),
    moe=MoEConfig(n_experts=60, top_k=4, n_shared=4, d_expert=1408),
    param_dtype="bfloat16",
)


def reduced() -> ModelConfig:
    return CONFIG.with_overrides(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=512, exit_layer=1,
        moe=MoEConfig(n_experts=4, top_k=2, n_shared=1, d_expert=128),
        param_dtype="float32", compute_dtype="float32")
