"""RecurrentGemma-2B [hybrid] — RG-LRU + local attention, 1:2 attn:recurrent
[arXiv:2402.19427].  26L, d_model 2560, 10 heads (MQA kv=1), d_ff 7680,
vocab 256000.  Griffin pattern period: (RG-LRU, RG-LRU, local attention),
window 2048.  head_dim 256.  A copy of ``repro.configs.recurrentgemma_2b``.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    arch_type="hybrid",
    source="arXiv:2402.19427",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    pattern=(LayerSpec("rglru"), LayerSpec("rglru"), LayerSpec("local_attn")),
    window=2048,
    d_rnn=2560,
    param_dtype="bfloat16",
    attn_shard="replicate",   # 10 heads / kv=1 do not divide the model axis
)


def reduced() -> ModelConfig:
    return CONFIG.with_overrides(
        n_layers=3, d_model=128, n_heads=4, n_kv_heads=1, head_dim=32,
        d_ff=256, d_rnn=128, vocab_size=512, window=16, exit_layer=3,
        param_dtype="float32", compute_dtype="float32")
