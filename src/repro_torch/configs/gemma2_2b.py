"""Gemma-2 2B [dense] — alternating local/global attention with logit
softcapping [arXiv:2408.00118].  26L, d_model 2304, 8 heads (GQA kv=4),
d_ff 9216, vocab 256000, window 4096, attn softcap 50, final softcap 30.
A copy of ``repro.configs.gemma2_2b``."""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    arch_type="dense",
    source="arXiv:2408.00118",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256_000,
    pattern=(LayerSpec("local_attn"), LayerSpec("attn")),
    window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    param_dtype="bfloat16",
    attn_shard="replicate",   # 8 heads < model axis (16)
)


def reduced() -> ModelConfig:
    return CONFIG.with_overrides(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512, window=16, exit_layer=2,
        param_dtype="float32", compute_dtype="float32")
