"""xLSTM-1.3B [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517].
48L, d_model 2048, 4 heads, no separate FFN (d_ff=0; blocks carry their own
projections).  xLSTM[7:1] ratio -> period (7x mLSTM, 1x sLSTM) x 6.
A copy of ``repro.configs.xlstm_1_3b``."""

from repro_torch.configs.base import LayerSpec, ModelConfig

_M = LayerSpec("mlstm", "none")
_S = LayerSpec("slstm", "none")

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    arch_type="ssm",
    source="arXiv:2405.04517",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    pattern=(_M, _M, _M, _M, _M, _M, _M, _S),
    mlstm_proj_factor=2.0,
    slstm_ff_factor=4.0 / 3.0,
    # 1024 (not 64): the (B, NH, DH, DH) chunk-boundary states are kept for
    # the backward pass, so fewer, larger chunks cut training memory at the
    # cost of a larger intra-chunk quadratic term
    mlstm_chunk=1024,
    param_dtype="bfloat16",
)


def reduced() -> ModelConfig:
    return CONFIG.with_overrides(
        n_layers=2, d_model=128, n_heads=2, n_kv_heads=2, vocab_size=512,
        pattern=(_M, _S), mlstm_chunk=8, exit_layer=2,
        param_dtype="float32", compute_dtype="float32")
