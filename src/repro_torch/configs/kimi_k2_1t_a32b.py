"""Kimi K2 [moe] — trillion-parameter MoE (paper-table entry)
[arXiv:2501.kimi2].  61L, d_model 7168, 64 heads (GQA kv=8), per-expert
d_ff 2048, vocab 163840; 384 routed experts top-8 + 1 shared.

As in the reference, every one of the 61 blocks is MoE (the real K2 keeps
its first block dense): 1.04e12 parameters, about 32B active.  Its head
dim, 112, is the one Dh of the zoo that K5's kernels pad (to 128 columns).
A copy of ``repro.configs.kimi_k2_1t_a32b``."""

from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    arch_type="moe",
    source="arXiv:2501.kimi2",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,
    d_ff=2048,
    vocab_size=163_840,
    pattern=(LayerSpec("attn", "moe"),),
    moe=MoEConfig(n_experts=384, top_k=8, n_shared=1, d_expert=2048),
    param_dtype="bfloat16",
    shard_experts_2d=True,    # the reference's mesh hint; one card here
)


def reduced() -> ModelConfig:
    return CONFIG.with_overrides(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=128, vocab_size=512, exit_layer=1,
        moe=MoEConfig(n_experts=4, top_k=2, n_shared=1, d_expert=128),
        shard_experts_2d=False,
        param_dtype="float32", compute_dtype="float32")
