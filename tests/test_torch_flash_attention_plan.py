"""The Python that plans a launch of K5's two kernels, and the wrapper's
choice of kernel, on the CPU (no card needed).

``ops.plan_wgmma`` decides what ``csrc/flash_attention_wgmma.cu`` is given:
rows per block (two warpgroups of 64), heads and queries per block, the
grid and the shared memory (Q plus a two-stage K/V ring, 128-byte
swizzled, plus 1 KiB for alignment), which must fit the 232,448 bytes a
block may opt into on an H100.  ``ops.plan_f32`` mirrors the launch of
the CUDA-core kernel (``csrc/flash_attention.cu``): 64 rows a block, 128
threads and 128-key tiles (256 of each at Dh 256), its shared memory (Q,
the two-chunk K/V ring, the tile's probabilities) within the same limit,
twice where Dh <= 128 so that two blocks share an SM (the card test
``test_flash_attention_f32_plan_is_the_kernels`` holds it to the
kernel's own count).  The file imports only torch, so it also runs on a
machine with the card and no JAX.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops  # noqa: E402

BF16 = torch.bfloat16
SMEM_LIMIT = 232_448     # shared memory an H100 block may opt into
# the columns a row of Q, K and V takes in each kernel's shared memory:
# Dh padded with zero columns to whole 64-column blocks (tensor cores) or
# to 32, 64, 128 or 256 (CUDA cores); kimi-k2's Dh 112 runs as 128
TC_WIDTH = {32: 64, 64: 64, 112: 128, 128: 128, 256: 256}
F32_WIDTH = {32: 32, 64: 64, 112: 128, 128: 128, 256: 256}


@pytest.mark.parametrize("dh", ops.HEAD_DIMS)
def test_plan_fits_shared_memory_at_every_head_dim(dh):
    plan = ops.plan_wgmma(4, 4096, 10, 1, dh, BF16)
    dp = TC_WIDTH[dh]
    assert ops.wgmma_width(dh) == dp
    assert plan.smem_bytes == 2 * dp * (128 + 2 * 2 * 64) + 1024
    assert plan.smem_bytes <= SMEM_LIMIT
    if dh == 256:       # Q 64 KiB + 2 x (K 32 KiB + V 32 KiB) + 1 KiB
        assert plan.smem_bytes == 192 * 1024 + 1024


@pytest.mark.parametrize("h,kh,g_blk,bq,n_groups", [
    (10, 1, 10, 12, 1),       # recurrentgemma's MQA: 120 of 128 rows
    (8, 4, 2, 64, 1),         # gemma2's GQA: 128 rows
    (6, 2, 3, 42, 1),         # G = 3: 126 rows
    (4, 4, 1, 128, 1),        # MHA
    (70, 1, 70, 1, 1),        # G = 70: one query a block
    (130, 1, 128, 1, 2),      # G = 130: two head groups of one kv head
])
def test_plan_rows_are_query_major_pairs_of_one_kv_head(h, kh, g_blk, bq,
                                                        n_groups):
    b, s = 3, 1000
    plan = ops.plan_wgmma(b, s, h, kh, 64, BF16)
    assert (plan.g_blk, plan.bq, plan.n_groups) == (g_blk, bq, n_groups)
    assert plan.g_blk * plan.bq <= ops.TC_ROWS
    assert plan.n_qblocks == -(-s // bq)
    assert plan.grid == plan.n_qblocks * n_groups * b * kh
    assert plan.n_qblocks * plan.bq >= s > (plan.n_qblocks - 1) * plan.bq


def test_plan_of_the_serving_shapes():
    rg = ops.plan_wgmma(4, 4096, 10, 1, 256, BF16)
    assert (rg.bq, rg.n_qblocks, rg.grid) == (12, 342, 1368)
    g2 = ops.plan_wgmma(1, 8192, 8, 4, 256, BF16)
    assert (g2.bq, g2.n_qblocks, g2.grid) == (64, 128, 512)


def test_plan_of_the_moe_serving_shapes():
    """qwen2-moe-a2.7b's prefill (MHA, 16 heads of 128: one head a row
    group, 128 queries a block) and kimi-k2's (GQA 64 / 8 of 112, padded
    to 128 columns: Q 32 KiB + 2 x (K 16 KiB + V 16 KiB) + 1 KiB)."""
    qw = ops.plan_wgmma(1, 4096, 16, 16, 128, BF16)
    assert (qw.g_blk, qw.bq, qw.n_qblocks, qw.grid) == (1, 128, 32, 512)
    ki = ops.plan_wgmma(1, 4096, 64, 8, 112, BF16)
    assert (ki.g_blk, ki.bq, ki.n_qblocks, ki.grid) == (8, 16, 256, 2048)
    assert ki.smem_bytes == 96 * 1024 + 1024 == qw.smem_bytes


F32 = torch.float32
SM_SMEM = 233_472        # shared memory of an H100 SM (228 KiB)


@pytest.mark.parametrize("dh", ops.HEAD_DIMS)
def test_f32_plan_fits_shared_memory_at_every_head_dim(dh):
    plan = ops.plan_f32(4, 4096, 10, 1, dh, F32)
    keys = 256 if dh == 256 else 128
    assert plan.threads == keys
    dp = F32_WIDTH[dh]
    assert ops.f32_width(dh) == dp
    # Q (64 rows of Dh + 4, Dh padded), two ring chunks of keys x 36, P
    # (64 x keys + 16)
    assert plan.smem_bytes == 4 * (64 * (dp + 4) + 2 * keys * 36
                                   + 64 * (keys + 16))
    assert plan.smem_bytes <= SMEM_LIMIT
    # each block also holds 1 KiB the card reserves
    assert plan.blocks_per_sm * (plan.smem_bytes + 1024) <= SM_SMEM
    assert plan.blocks_per_sm == (1 if dh == 256 else 2)


@pytest.mark.parametrize("h,kh,g_blk,bq,n_groups", [
    (10, 1, 10, 6, 1),        # recurrentgemma's MQA: 60 of 64 rows
    (8, 4, 2, 32, 1),         # gemma2's GQA: 64 rows
    (6, 2, 3, 21, 1),         # G = 3: 63 rows
    (4, 4, 1, 64, 1),         # MHA
    (70, 1, 64, 1, 2),        # G = 70: two head groups
    (130, 1, 64, 1, 3),       # G = 130: three head groups of a kv head
])
def test_f32_plan_rows_are_query_major_pairs_of_one_kv_head(h, kh, g_blk,
                                                            bq, n_groups):
    b, s = 3, 1000
    plan = ops.plan_f32(b, s, h, kh, 64, F32)
    assert (plan.g_blk, plan.bq, plan.n_groups) == (g_blk, bq, n_groups)
    assert plan.g_blk * plan.bq <= ops.F32_ROWS
    assert plan.n_qblocks == -(-s // bq)
    assert plan.grid == plan.n_qblocks * n_groups * b * kh
    assert plan.n_qblocks * plan.bq >= s > (plan.n_qblocks - 1) * plan.bq


def test_f32_plan_of_the_timed_shapes():
    rg = ops.plan_f32(4, 4096, 10, 1, 256, F32)
    assert (rg.bq, rg.n_qblocks, rg.grid, rg.threads) == (6, 683, 2732, 256)
    g2 = ops.plan_f32(1, 8192, 8, 4, 256, F32)
    assert (g2.bq, g2.n_qblocks, g2.grid) == (32, 256, 1024)


def test_f32_plan_of_head_dim_112():
    """The untimed Dh 112 case of the smoke run (G = 4): 128 threads and
    128-key tiles as at Dh 128, Q 64 x 132 floats, two blocks an SM."""
    p = ops.plan_f32(2, 1000, 8, 2, 112, F32)
    assert (p.g_blk, p.bq, p.n_qblocks, p.grid, p.threads) == (4, 16, 63,
                                                               252, 128)
    assert p.smem_bytes == 4 * (64 * 132 + 2 * 128 * 36 + 64 * 144) \
        == ops.plan_f32(2, 1000, 8, 2, 128, F32).smem_bytes
    assert p.blocks_per_sm == 2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_f32_plan_raises_on_a_dtype_the_kernel_does_not_take(dtype):
    with pytest.raises(ValueError, match="float32"):
        ops.plan_f32(1, 64, 2, 1, 64, dtype)


@pytest.mark.parametrize("dh", [16, 48, 96, 512])
def test_f32_plan_raises_on_an_unsupported_head_dim(dh):
    with pytest.raises(ValueError, match="head_dim"):
        ops.plan_f32(1, 64, 2, 1, dh, F32)


def test_f32_plan_raises_beyond_the_grid():
    with pytest.raises(ValueError, match="grid"):
        ops.plan_f32(2**24, 2**16, 1, 1, 64, F32)


class _OnCard(torch.Tensor):
    """A ``meta`` tensor that reports itself on the card, so the wrapper
    takes its kernel branch (a plain ``meta`` tensor takes the wrapper's
    shape-only ``meta`` path); PyTorch's own functions see a ``meta``
    tensor."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    @property
    def device(self):
        return torch.device("cuda")


@pytest.mark.parametrize("dtype,plan", [(torch.float32, "plan_f32"),
                                        (torch.bfloat16, "plan_wgmma")])
def test_each_dtype_plans_its_own_kernel(monkeypatch, dtype, plan):
    """On a CUDA tensor the wrapper plans f32 for the CUDA-core kernel and
    bf16 for the tensor-core one (the launch itself needs the card: the
    plan stops it here)."""
    calls = []

    def stop(*args):
        calls.append((plan, args[-1]))
        raise RuntimeError("planned")
    monkeypatch.setattr(ops, plan, stop)
    q = torch.empty((1, 16, 2, 32), dtype=dtype,
                    device="meta").as_subclass(_OnCard)
    k = torch.empty((1, 16, 1, 32), dtype=dtype,
                    device="meta").as_subclass(_OnCard)
    monkeypatch.setattr(ops, "_check", lambda *a: None)
    with pytest.raises(RuntimeError, match="planned"):
        ops.flash_attention(q, k, k)
    assert calls == [(plan, dtype)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_plan_raises_on_a_dtype_the_kernel_does_not_take(dtype):
    with pytest.raises(ValueError, match="bfloat16"):
        ops.plan_wgmma(1, 64, 2, 1, 64, dtype)


@pytest.mark.parametrize("dh", [16, 48, 96, 512])
def test_plan_raises_on_an_unsupported_head_dim(dh):
    with pytest.raises(ValueError, match="head_dim"):
        ops.plan_wgmma(1, 64, 2, 1, dh, BF16)


def test_plan_raises_beyond_the_grid():
    with pytest.raises(ValueError, match="grid"):
        ops.plan_wgmma(2**24, 2**16, 1, 1, 64, BF16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_run_the_plain_version_and_count_no_launch(dtype):
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 20, 4, 32), generator=g).to(dtype)
    k = torch.randn((1, 20, 2, 32), generator=g).to(dtype)
    v = torch.randn((1, 20, 2, 32), generator=g).to(dtype)
    fa = ops.flash_attention
    before = (fa.launches, fa.launches_tc)
    got = fa(q, k, v, window=5)
    assert (fa.launches, fa.launches_tc) == before
    torch.testing.assert_close(got, ops.flash_attention_ref(q, k, v,
                                                            window=5),
                               rtol=0, atol=0)


def test_float16_raises_on_every_device():
    q = torch.zeros((1, 4, 2, 32), dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        ops.flash_attention(q, q[:, :, :1], q[:, :, :1])
