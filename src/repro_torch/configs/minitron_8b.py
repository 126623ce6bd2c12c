"""Minitron-8B [dense] — width/depth-pruned Nemotron-4 [arXiv:2407.14679].
32L, d_model 4096, 32 heads (GQA kv=8), d_ff 16384, vocab 256000.
A copy of ``repro.configs.minitron_8b``."""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    arch_type="dense",
    source="arXiv:2407.14679",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16_384,
    vocab_size=256_000,
    pattern=(LayerSpec("attn"),),
    param_dtype="bfloat16",
)


def reduced() -> ModelConfig:
    return CONFIG.with_overrides(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512, exit_layer=1,
        param_dtype="float32", compute_dtype="float32")
