"""The port's CUDA kernels against their plain PyTorch versions, on the card.

K1 contracts its multiply-add to an FMA (tolerance 1e-6); K2, K3 and K4
round each product and sum as their plain versions do, in the same order,
so they are held bitwise.

Every test here needs a CUDA card (a hand-written kernel has no CPU mode):
marked ``cuda``, each skips without one.  The file imports only torch and
numpy, so it runs on a machine with the card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro_torch.kernels.masked_agg import ops  # noqa: E402
from repro_torch.kernels.masked_agg.ref import (  # noqa: E402
    masked_agg_acc_deq_ref, masked_agg_acc_ref, masked_agg_ref,
    masked_scatter_acc_ref)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(z, n, seed):
    """Row 1 is NaN at weight 0; row 2 has weight 0 on both branches;
    row 3 weight 0 inside M only."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(z, n)).astype(np.float32)
    x[1] = np.nan
    mask = rng.random(n) < 0.4
    w_m = rng.uniform(0.2, 1.5, size=z).astype(np.float32)
    w_rest = rng.uniform(0.2, 1.5, size=z).astype(np.float32)
    w_m[1] = w_rest[1] = w_m[2] = w_rest[2] = w_m[3] = 0.0
    acc = rng.normal(size=n).astype(np.float32)
    return acc, x, mask, w_m, w_rest


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("z,n,offset", [(5, 4096, 0), (4, 1001, 0),
                                        (6, 2048 + 3, 0), (4, 4096, 1)])
def test_masked_agg_acc_matches_plain_version(cuda, dtype, z, n, offset):
    # n % 4 != 0 and offset 1 (a misaligned acc) take the scalar kernel
    acc, x, mask, w_m, w_rest = _inputs(z, n, seed=z * n + offset)
    args = [torch.from_numpy(a).to(cuda) for a in (x, mask, w_m, w_rest)]
    args[0] = args[0].to(getattr(torch, dtype))
    store = torch.zeros(n + offset, device=cuda)
    acc_t = store[offset:]
    acc_t.copy_(torch.from_numpy(acc))
    want = masked_agg_acc_ref(acc_t.clone(), *args)
    before = ops.masked_agg_acc_.launches
    assert ops.masked_agg_acc_(acc_t, *args) is acc_t
    torch.cuda.synchronize()
    assert ops.masked_agg_acc_.launches == before + 1
    assert bool(torch.isfinite(acc_t).all())
    # nvcc contracts the multiply-add to an FMA, the plain version does not
    torch.testing.assert_close(acc_t, want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_masked_agg_acc_rejects_mixed_devices(cuda):
    acc, x, mask, w_m, w_rest = (torch.from_numpy(a) for a in
                                 _inputs(4, 64, seed=1))
    with pytest.raises(ValueError):
        ops.masked_agg_acc_(acc.to(cuda), x, mask, w_m, w_rest)


def _wire_inputs(z, n, quant_block, seed):
    """K2 inputs: int8 payload and per-group scales; row 1 has NaN scales
    at weight 0, row 2 weight 0 on both branches, row 3 inside M only."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, size=(z, n), dtype=np.int8)
    scales = rng.uniform(0.0, 0.1, size=(z, n // quant_block)).astype(
        np.float32)
    scales[1] = np.nan
    _, _, mask, w_m, w_rest = _inputs(z, n, seed)
    acc = rng.normal(size=n).astype(np.float32)
    return acc, q, scales, mask, w_m, w_rest


@pytest.mark.cuda
@pytest.mark.parametrize("z,n,quant_block,offset", [
    (5, 4096, 128, 0), (5, 4096, 32, 0), (4, 4096, 8, 0), (4, 1003, 1, 0),
    (4, 2048 + 8, 8, 0), (4, 4096, 128, 1)])
def test_masked_agg_acc_deq_matches_plain_version(cuda, z, n, quant_block,
                                                  offset):
    # n % 16 != 0 and offset 1 (a misaligned acc) take the scalar kernel
    acc, q, scales, mask, w_m, w_rest = _wire_inputs(z, n, quant_block,
                                                     seed=z * n + offset)
    args = [torch.from_numpy(a).to(cuda) for a in (q, scales, mask, w_m,
                                                   w_rest)]
    store = torch.zeros(n + offset, device=cuda)
    acc_t = store[offset:]
    acc_t.copy_(torch.from_numpy(acc))
    want = masked_agg_acc_deq_ref(acc_t.clone(), *args,
                                  quant_block=quant_block)
    before = ops.masked_agg_acc_deq_.launches
    assert ops.masked_agg_acc_deq_(acc_t, *args,
                                   quant_block=quant_block) is acc_t
    torch.cuda.synchronize()
    assert ops.masked_agg_acc_deq_.launches == before + 1
    assert bool(torch.isfinite(acc_t).all())
    # products and sums rounded one by one in the plain version's order
    torch.testing.assert_close(acc_t, want, rtol=0, atol=0)


def _scatter_inputs(z, n, k, dtype, quant_block, seed):
    """K3 inputs: sorted distinct indices per row, colliding across rows;
    row 1 NaN at weight 0 on both branches, row 2 weight 0 inside M."""
    rng = np.random.default_rng(seed)
    idx = np.stack([np.sort(rng.choice(n, size=k, replace=False))
                    for _ in range(z)]).astype(np.int32)
    values = rng.normal(size=(z, k)).astype(np.float32)
    scales = None
    if dtype == "int8":
        values = rng.integers(-127, 128, size=(z, k), dtype=np.int8)
        scales = rng.uniform(0.0, 0.1, size=(z, k // quant_block)).astype(
            np.float32)
        scales[1] = np.nan
    else:
        values[1] = np.nan
    mask = rng.random(n) < 0.4
    w_m = rng.uniform(0.2, 1.5, size=z).astype(np.float32)
    w_rest = rng.uniform(0.2, 1.5, size=z).astype(np.float32)
    w_m[1] = w_rest[1] = w_m[2] = 0.0
    acc = rng.normal(size=n).astype(np.float32)
    return acc, values, scales, idx, mask, w_m, w_rest


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("z,n,k", [(5, 40_000, 3072), (3, 20_011, 19_968),
                                   (4, 100_000, 128)])
def test_masked_scatter_acc_matches_plain_version(cuda, dtype, z, n, k):
    acc, values, scales, idx, mask, w_m, w_rest = _scatter_inputs(
        z, n, k, dtype, 128, seed=z * n + k)
    vt = torch.from_numpy(values)
    if dtype == "bfloat16":
        vt = vt.to(torch.bfloat16)
    args = [vt.to(cuda), None if scales is None else
            torch.from_numpy(scales).to(cuda)]
    args += [torch.from_numpy(a).to(cuda) for a in (idx, mask, w_m, w_rest)]
    acc_t = torch.from_numpy(acc).to(cuda)
    want = masked_scatter_acc_ref(acc_t.clone(), *args, quant_block=128)
    before = ops.masked_scatter_acc_.launches
    assert ops.masked_scatter_acc_(acc_t, *args, quant_block=128) is acc_t
    torch.cuda.synchronize()
    assert ops.masked_scatter_acc_.launches == before + 1
    assert bool(torch.isfinite(acc_t).all())
    torch.testing.assert_close(acc_t, want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("z,n,ld,offset", [
    (5, 4096, 4096, 0), (5, 1, 1, 0), (4, 1001, 1001, 0),
    (5, 2048 + 3, 2048 + 3, 0), (5, 4096, 8192, 0), (5, 4096, 4096, 1),
    (5, 1000, 2050, 0)])
def test_masked_agg_matches_plain_version(cuda, dtype, z, n, ld, offset):
    # ld > n: a leaf's view of the packed chunk buffer; n % 4 != 0, ld %
    # 4 != 0 and offset 1 (misaligned rows) take the scalar kernel
    x, mask, w_m, w_rest = _inputs(z, n, seed=z * n + ld + offset)[1:]
    buf = torch.zeros((z * ld + offset,), device=cuda,
                      dtype=getattr(torch, dtype))
    xt = buf[offset:].as_strided((z, n), (ld, 1))
    xt.copy_(torch.from_numpy(x))
    args = [torch.from_numpy(a).to(cuda) for a in (mask, w_m, w_rest)]
    want = masked_agg_ref(xt, *args)
    before = ops.masked_agg_.launches
    got = ops.masked_agg_(xt, *args)
    torch.cuda.synchronize()
    assert ops.masked_agg_.launches == before + 1
    assert got.dtype == xt.dtype and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
def test_masked_agg_tree_folds_every_leaf_on_the_card(cuda):
    from repro_torch.core import flatten, masking
    from repro_torch.models import resnet
    from repro_torch.tree import tree_leaves, tree_map
    params = resnet.init_params(torch.Generator().manual_seed(0), 10,
                                (8, 8, 8, 8))
    layout = flatten.build_layout(params, total_multiple=2048)
    flat_mask = flatten.pack_mask(layout, masking.resnet_subnet_mask(params),
                                  cuda)
    xz = torch.randn((3, layout.n_flat), device=cuda)
    w_m = torch.tensor([1.0, 0.0, 0.5], device=cuda)
    w_rest = torch.tensor([0.25, 2.0, 0.0], device=cuda)
    leaf_masks = flatten.unpack(layout, flat_mask, cast=False)
    before = ops.masked_agg_.launches
    got = ops.masked_agg_tree(flatten.unpack_stacked(layout, xz), leaf_masks,
                              w_m, w_rest)
    torch.cuda.synchronize()
    assert ops.masked_agg_.launches == before + layout.n_leaves
    want = tree_map(lambda x, m: masked_agg_ref(
        x.reshape(3, -1), m.reshape(-1), w_m, w_rest).reshape(x.shape[1:]),
        flatten.unpack_stacked(layout, xz), leaf_masks)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
