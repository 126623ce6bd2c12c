"""StarCoder2-15B [dense] — GQA + RoPE [arXiv:2402.19173].
40L, d_model 6144, 48 heads (GQA kv=4), d_ff 24576, vocab 49152.
Pure full attention: long_500k runs the sliding-window variant
(longctx_window) and is flagged as such in the dry-run record.
A copy of ``repro.configs.starcoder2_15b``."""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    arch_type="dense",
    source="arXiv:2402.19173",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    head_dim=128,
    d_ff=24_576,
    vocab_size=49_152,
    pattern=(LayerSpec("attn"),),
    rope_theta=1_000_000.0,
    mlp_glu=False,            # StarCoder2 uses a plain (2-matrix) MLP
    param_dtype="bfloat16",
)


def reduced() -> ModelConfig:
    return CONFIG.with_overrides(
        n_layers=2, d_model=192, n_heads=6, n_kv_heads=2, head_dim=32,
        d_ff=512, vocab_size=512, exit_layer=1,
        param_dtype="float32", compute_dtype="float32")
