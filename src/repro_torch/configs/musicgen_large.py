"""MusicGen-Large [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284].  48L, d_model 2048, 32 heads (MHA kv=32), d_ff 8192,
vocab 2048 per codebook; 4 parallel codebooks (the delay pattern is the
data pipeline's), their token embeddings summed, one output head per
codebook over the tied tables.

The text-conditioning encoder (T5) and the EnCodec codec are stubs: the
caller provides precomputed conditioning embeddings (64 tokens, d_in
1024), prepended to the sequence after projection, and EnCodec tokens
directly.
A copy of ``repro.configs.musicgen_large``."""

from repro_torch.configs.base import LayerSpec, ModelConfig, StubFrontend

CONFIG = ModelConfig(
    name="musicgen-large",
    arch_type="audio",
    source="arXiv:2306.05284",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    n_codebooks=4,
    mlp_glu=False,            # the plain transformer FFN (Audiocraft)
    pattern=(LayerSpec("attn"),),
    frontend=StubFrontend(kind="audio_conditioning", n_tokens=64, d_in=1024),
    param_dtype="bfloat16",
)


def reduced() -> ModelConfig:
    return CONFIG.with_overrides(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab_size=64, exit_layer=1, n_codebooks=2,
        frontend=StubFrontend(kind="audio_conditioning", n_tokens=4, d_in=32),
        param_dtype="float32", compute_dtype="float32")
