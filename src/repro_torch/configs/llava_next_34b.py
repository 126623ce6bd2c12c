"""LLaVA-NeXT 34B-class [vlm] — anyres tiling.  Backbone: 60L, d_model
7168, 56 heads (GQA kv=8), head dim 128, d_ff 20480, vocab 64000: the
widths of llava-v1.6-34b (hf:llava-hf/llava-v1.6-34b-hf, a Yi-34B
language model).  ``source`` names the 7B Mistral checkpoint as the
reference's does, so that the two configs stay equal field for field.

The vision tower is a stub: the caller provides precomputed patch
embeddings (anyres 4 tiles + base = 5 x 576 = 2880 tokens, d_in 1152,
SigLIP width); the backbone owns only the projector (one linear here) and
prepends the projected patches to the text.
A copy of ``repro.configs.llava_next_34b``."""

from repro_torch.configs.base import LayerSpec, ModelConfig, StubFrontend

CONFIG = ModelConfig(
    name="llava-next-34b",
    arch_type="vlm",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20_480,
    vocab_size=64_000,
    pattern=(LayerSpec("attn"),),
    frontend=StubFrontend(kind="vision", n_tokens=2880, d_in=1152),
    param_dtype="bfloat16",
    attn_shard="head_dim",
)


def reduced() -> ModelConfig:
    return CONFIG.with_overrides(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512, exit_layer=1,
        frontend=StubFrontend(kind="vision", n_tokens=8, d_in=48),
        param_dtype="float32", compute_dtype="float32")
