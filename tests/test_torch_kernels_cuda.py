"""The port's CUDA kernels against their plain PyTorch versions, on the card.

K1 contracts its multiply-add to an FMA (tolerance 1e-6); K2, K3, K4 (its
one-shot entry and the tree engine's one-launch fold) and K6 round each
product and sum as their plain versions do, in the same order, so they are
held bitwise.  K5 sums its scores and its PV product in
another order than its plain version (cuBLAS): f32 (the CUDA-core kernel)
at rtol = atol = 1e-5, bf16 (the tensor-core kernel, which also rounds the
probabilities to bf16 for the PV product) within one bf16 rounding
(rtol = atol = 2**-7).

Every test here needs a CUDA card (a hand-written kernel has no CPU mode):
marked ``cuda``, each skips without one.  The file imports only torch and
numpy, so it runs on a machine with the card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_ref  # noqa: E402
from repro_torch.kernels.masked_agg import ops  # noqa: E402
from repro_torch.kernels.masked_agg.ref import (  # noqa: E402
    masked_agg_acc_deq_ref, masked_agg_acc_ref, masked_agg_fold_ref,
    masked_agg_ref, masked_scatter_acc_ref)
from repro_torch.kernels.rglru_scan import ops as scan_ops  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import lru_scan_ref  # noqa: E402


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


@functools.lru_cache(maxsize=None)
def _model_mask():
    """The index-set-M mask of the narrow PreActResNet18-GN's flat layout
    (widths 8, 16, 16, 16; 36,864 elements): M's long runs, as the simple
    population's folds see them."""
    from repro_torch.core import flatten
    from repro_torch.core.adapters import ResNetAdapter
    adapter = ResNetAdapter(10, (8, 16, 16, 16))
    params = adapter.init(torch.Generator().manual_seed(0), "cpu")
    layout = flatten.build_layout(params, total_multiple=2048)
    return flatten.pack_mask(layout, adapter.subnet_mask(params), "cpu")


# (payload, quant_block, path): the vector kernels, the scalar ones on a
# misaligned acc, and on a ragged N (which quant_block 128 cannot divide)
DEAD_ROW_CASES = [(kind, qb, path)
                  for kind, qb in (("float32", 0), ("bfloat16", 0),
                                   ("int8", 128), ("int8", 1))
                  for path in ("vector", "misaligned", "ragged")
                  if not (qb == 128 and path == "ragged")]


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("kind,quant_block,path", DEAD_ROW_CASES)
def test_dead_rows_fold_as_acc_plus_zero(request, device, kind, quant_block,
                                         path):
    """K1 (f32, bf16 rows) and K2 (int8 at quant_block 128 and 1) where
    rows are dead: a simple fold (w_rest 0) and an all-dead launch, at the
    model's M and at a random mask, row 2 NaN (K2: NaN scales) at weight
    0, acc holding -0.0 at every 7th element.  Each is held to its plain
    version (K1 at its FMA tolerance, K2 bitwise), and every element that
    no live row touches bitwise to ``acc + 0.0``: the redesigned kernels
    skip those elements' loads and stores.  On the CPU the wrappers run
    the plain versions, which the same contract holds."""
    if device == "cuda":
        request.getfixturevalue("cuda")
    z, rng = 5, np.random.default_rng(len(kind) * 10 + quant_block)
    model = _model_mask()
    n = model.numel() - (5 if path == "ragged" else 0)
    acc0 = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    acc0[::7] = -0.0
    if kind == "int8":
        payload = [torch.from_numpy(rng.integers(-127, 128, size=(z, n),
                                                 dtype=np.int8)),
                   torch.from_numpy(rng.uniform(0.0, 0.1, size=(
                       z, n // quant_block)).astype(np.float32))]
        payload[1][2] = float("nan")
        fold = functools.partial(ops.masked_agg_acc_deq_,
                                 quant_block=quant_block)
        plain = functools.partial(masked_agg_acc_deq_ref,
                                  quant_block=quant_block)
        tol = dict(rtol=0, atol=0)
    else:
        x = torch.from_numpy(rng.normal(size=(z, n)).astype(np.float32))
        x[2] = float("nan")
        payload = [x.to(getattr(torch, kind))]
        fold, plain = ops.masked_agg_acc_, masked_agg_acc_ref
        tol = dict(rtol=1e-6, atol=1e-6)    # K1's FMA against the plain
    payload = [t.to(device) for t in payload]
    masks = (model[:n], torch.from_numpy(rng.random(n) < 0.3))
    zero = torch.zeros(z)
    for mask in masks:
        for w_m, w_rest in ((torch.tensor([1.0, 1.0, 0.0, 0.5, 1.0]), zero),
                            (zero, zero)):
            mask, w_m, w_rest = (t.to(device) for t in (mask, w_m, w_rest))
            start = acc0.to(device)
            want = plain(start, *payload, mask, w_m, w_rest)
            offset = int(path == "misaligned")
            acc = torch.zeros(n + offset, device=device)[offset:]
            acc.copy_(start)
            fold(acc, *payload, mask, w_m, w_rest)
            torch.testing.assert_close(acc, want, **tol)
            dead = ~((mask & bool((w_m > 0).any()))
                     | (~mask & bool((w_rest > 0).any())))
            assert int(dead.sum()) > 0
            assert torch.equal(acc.view(torch.int32)[dead],
                               (start + 0.0).view(torch.int32)[dead])


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
    assert ops.masked_scatter_acc_.launches == before + 2   # bounds, apply
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
    # 4 != 0 and offset 1 (misaligned rows) take scalar loads
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


def _scatter_case(case, dtype, seed, cuda):
    """K3 at the main path's two populations and its edges, N = 400,000:
    "complex" k = 1/14 of every position, "simple" every index inside M,
    Z = 1 with k = quant_block, k = quant_block, every index in one span.
    Row 1 is NaN at weight 0 on both branches (NaN scales for int8)."""
    rng = np.random.default_rng(seed)
    n, qb = 400_000, 128
    mask = rng.random(n) < 0.06
    z, k, pool = {"complex": (5, 28_672, np.arange(n)),
                  "simple": (5, 1_792, np.nonzero(mask)[0]),
                  "z1": (1, qb, np.arange(n)),
                  "k_qb": (5, qb, np.arange(n)),
                  "one_span": (5, 256, np.arange(199_000, 200_024))}[case]
    idx = np.stack([np.sort(rng.choice(pool, size=k, replace=False))
                    for _ in range(z)]).astype(np.int32)
    values = torch.from_numpy(rng.normal(size=(z, k)).astype(np.float32))
    scales = None
    if dtype == "int8":
        values = torch.from_numpy(rng.integers(-127, 128, size=(z, k),
                                               dtype=np.int8))
        scales = torch.from_numpy(rng.uniform(
            0.0, 0.1, size=(z, k // qb)).astype(np.float32)).to(cuda)
        if z > 1:
            scales[1] = float("nan")
    else:
        values = values.to(torch.bfloat16)
        if z > 1:
            values[1] = float("nan")
    w_m = rng.uniform(0.2, 1.5, size=z).astype(np.float32)
    w_rest = rng.uniform(0.2, 1.5, size=z).astype(np.float32)
    if z > 1:
        w_m[1] = w_rest[1] = w_m[2] = 0.0
    acc = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(cuda)
    return acc, [values.to(cuda), scales] + [
        torch.from_numpy(a).to(cuda) for a in (idx, mask, w_m, w_rest)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("case", ["complex", "simple", "z1", "k_qb",
                                  "one_span"])
def test_masked_scatter_acc_cases_match_plain_version(cuda, dtype, case):
    acc, args = _scatter_case(case, dtype, seed=len(case), cuda=cuda)
    want = masked_scatter_acc_ref(acc.clone(), *args, quant_block=128)
    before = ops.masked_scatter_acc_.launches
    assert ops.masked_scatter_acc_(acc, *args, quant_block=128) is acc
    torch.cuda.synchronize()
    assert ops.masked_scatter_acc_.launches == before + 2
    assert bool(torch.isfinite(acc).all())
    torch.testing.assert_close(acc, want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("stream", ["float32", "bfloat16"])
def test_masked_agg_fold_is_one_launch_over_every_leaf(cuda, stream):
    # the tree engine's fold of full-width PreActResNet18-GN: all 59 leaves
    # accumulated in one launch, bitwise against acc + the plain one-shot
    # sum of each leaf (a bf16 stream widened first, as the engine does);
    # then the one-shot entry on every leaf in the stream's dtype
    from repro_torch.core import flatten
    from repro_torch.core.adapters import ResNetAdapter
    adapter = ResNetAdapter(10)
    params = adapter.init(torch.Generator().manual_seed(0), "cpu")
    layout = flatten.build_layout(params, total_multiple=2048)
    flat_mask = flatten.pack_mask(layout, adapter.subnet_mask(params), cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    xz = torch.randn((5, layout.n_flat), generator=g, device=cuda).to(
        getattr(torch, stream))
    xz[1] = float("nan")
    w_m = torch.tensor([1.0, 0.0, 0.0, 0.5, 1.0], device=cuda)
    w_rest = torch.tensor([1.0, 0.0, 0.7, 0.0, 0.25], device=cuda)
    acc = torch.randn((layout.n_flat,), generator=g, device=cuda)
    plan = ops.fold_plan(layout, cuda)
    x32 = xz.to(torch.float32)
    want = masked_agg_fold_ref(acc, x32, flat_mask, w_m, w_rest,
                               plan.leaves.cpu())
    got = acc.clone()
    before = ops.masked_agg_fold_.launches
    assert ops.masked_agg_fold_(got, x32, flat_mask, w_m, w_rest, plan) is got
    torch.cuda.synchronize()
    assert ops.masked_agg_fold_.launches == before + 1
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    before = ops.masked_agg_.launches
    for s in layout.slots:
        rows = xz[:, s.offset:s.offset + s.size]
        m = flat_mask[s.offset:s.offset + s.size]
        torch.testing.assert_close(ops.masked_agg_(rows, m, w_m, w_rest),
                                   masked_agg_ref(rows, m, w_m, w_rest),
                                   rtol=0, atol=0)
    assert ops.masked_agg_.launches == before + layout.n_leaves


@pytest.mark.cuda
def test_refused_fold_launches_raise(cuda, monkeypatch):
    acc, x, mask, w_m, w_rest = (torch.from_numpy(a).to(cuda) for a in
                                 _inputs(4, 4096, seed=2))
    before = (ops.masked_agg_.launches, ops.masked_scatter_acc_.launches)
    monkeypatch.setattr(ops, "TILE", 256)      # not the kernel's item length
    with pytest.raises(RuntimeError, match="masked_agg launch failed"):
        ops.masked_agg_(x, mask, w_m, w_rest)
    # a span below the kernel's least
    monkeypatch.setattr(ops, "SCATTER_SPAN", (512, 512))
    idx = torch.arange(0, 4096, 32, device=cuda,
                       dtype=torch.int32).repeat(4, 1)
    with pytest.raises(RuntimeError, match="masked_scatter_acc launch failed"):
        ops.masked_scatter_acc_(acc, torch.ones((4, 128), device=cuda), None,
                                idx, mask, w_m, w_rest, quant_block=128)
    assert (ops.masked_agg_.launches,
            ops.masked_scatter_acc_.launches) == before


def _qkv(cuda, b, s, h, kh, dh, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    dt = getattr(torch, dtype)
    q = torch.randn((b, s, h, dh), generator=g, device=cuda) * 2
    k = torch.randn((b, s, kh, dh), generator=g, device=cuda) * 2
    v = torch.randn((b, s, kh, dh), generator=g, device=cuda)
    return q.to(dt), k.to(dt), v.to(dt)


def _flash_close(got, want, dtype):
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _flash_launch(q, k, v, **kw):
    """One K5 call; asserts it launched the kernel of its dtype's route
    once (bf16: tensor cores, f32: CUDA cores) and the other not at all."""
    fa = flash_ops.flash_attention
    before = (fa.launches_tc, fa.launches)
    got = fa(q, k, v, **kw)
    torch.cuda.synchronize()
    tc = q.dtype == torch.bfloat16
    assert (fa.launches_tc, fa.launches) == (before[0] + tc,
                                             before[1] + (not tc))
    assert got.dtype == q.dtype and bool(torch.isfinite(got).all())
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kh,dh,window,cap,dtype", [
    (4, 4096, 10, 1, 256, 2048, 0.0, "bfloat16"),  # recurrentgemma-2b
    (1, 8192, 8, 4, 256, 4096, 50.0, "bfloat16"),  # gemma2-2b local
    (1, 8192, 8, 4, 256, 0, 50.0, "bfloat16"),     # gemma2-2b global
    (2, 1000, 4, 2, 128, 300, 0.0, "float32"),     # ragged S
    (2, 777, 6, 3, 64, 0, 30.0, "float32"),
    (3, 513, 5, 5, 32, 40, 0.0, "float32"),        # Dh 32, MHA
    (1, 200, 70, 1, 64, 0, 0.0, "bfloat16"),       # G = 70 > 64 rows
    (2, 64, 4, 2, 32, 1000, 0.0, "float32"),       # window >= S
    (1, 4096, 64, 8, 112, 0, 0.0, "bfloat16"),     # kimi-k2-1t-a32b
    (1, 4096, 16, 16, 128, 0, 0.0, "bfloat16"),    # qwen2-moe-a2.7b (MHA)
    (2, 1000, 8, 2, 112, 300, 30.0, "float32"),    # Dh 112 padded to 128
    (3, 513, 8, 8, 112, 0, 0.0, "bfloat16"),
    (2, 190, 4, 1, 112, 77, 0.0, "float32"),       # Dh 112, MQA
    (2, 333, 10, 1, 112, 100, 50.0, "bfloat16"),
])
def test_flash_attention_matches_plain_version(cuda, b, s, h, kh, dh, window,
                                               cap, dtype):
    q, k, v = _qkv(cuda, b, s, h, kh, dh, dtype, seed=s + h + dh)
    got = _flash_launch(q, k, v, window=window, softcap=cap)
    _flash_close(got, flash_attention_ref(q, k, v, window=window,
                                          softcap=cap), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kh,dh,window,cap", [
    (2, 300, 6, 2, 64, 0, 0.0),        # G = 3: 42 queries, 126 of 128 rows
    (2, 333, 10, 1, 128, 100, 0.0),    # G = 10: 12 queries, 120 rows
    (1, 1000, 8, 4, 256, 0, 50.0),     # S not a multiple of the 64-key tile
    (2, 517, 4, 2, 128, 200, 30.0),    # softcap with a window
    (1, 70, 130, 1, 64, 0, 0.0),       # G = 130: two head groups of a kv head
    (2, 190, 4, 1, 32, 0, 0.0),        # each Dh, MQA
    (2, 190, 4, 1, 64, 50, 0.0),
    (2, 190, 4, 1, 128, 0, 10.0),
    (2, 190, 4, 1, 256, 77, 0.0),
    (3, 1, 4, 2, 64, 0, 0.0),          # one query
    (2, 64, 4, 2, 32, 1000, 0.0),      # window >= S
])
def test_flash_attention_tensor_core_tile_edges(cuda, b, s, h, kh, dh,
                                                window, cap):
    q, k, v = _qkv(cuda, b, s, h, kh, dh, "bfloat16", seed=s + h + dh)
    got = _flash_launch(q, k, v, window=window, softcap=cap)
    _flash_close(got, flash_attention_ref(q, k, v, window=window,
                                          softcap=cap), "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kh,dh,window,cap", [
    (2, 1000, 6, 2, 64, 0, 0.0),       # ragged S, G = 3: 21 queries, 63 rows
    (2, 333, 10, 1, 256, 100, 0.0),    # G = 10: 6 queries, 60 rows; Dh 256
    (1, 70, 130, 1, 64, 0, 0.0),       # G = 130: three head groups
    (1, 70, 130, 1, 256, 0, 0.0),
    (2, 190, 4, 1, 32, 0, 0.0),        # Dh 32: one K chunk a tile
    (2, 517, 4, 2, 128, 200, 30.0),    # softcap with a window
    (1, 1000, 8, 4, 256, 0, 50.0),     # S not a multiple of the 256-key tile
    (2, 700, 2, 1, 64, 20, 0.0),       # window < a tile: whole tiles masked
    (2, 700, 8, 4, 256, 9, 30.0),      # ... at Dh 256, with a softcap
    (3, 1, 4, 2, 64, 0, 0.0),          # one query
    (2, 64, 4, 2, 32, 1000, 0.0),      # window >= S
])
def test_flash_attention_f32_tile_edges(cuda, b, s, h, kh, dh, window, cap):
    """The CUDA-core kernel at its tile edges (64 rows, 128-key tiles,
    256 at Dh 256), at the f32 tolerance."""
    q, k, v = _qkv(cuda, b, s, h, kh, dh, "float32", seed=s + h + dh)
    got = _flash_launch(q, k, v, window=window, softcap=cap)
    _flash_close(got, flash_attention_ref(q, k, v, window=window,
                                          softcap=cap), "float32")


@pytest.mark.cuda
@pytest.mark.parametrize("dh", flash_ops.HEAD_DIMS)
def test_flash_attention_f32_plan_is_the_kernels(cuda, dh):
    """``plan_f32``'s shared memory is what the kernel's launch asks for."""
    plan = flash_ops.plan_f32(1, 64, 2, 1, dh, torch.float32)
    assert flash_ops._lib().flash_attention_f32_smem(dh) == plan.smem_bytes


@pytest.mark.cuda
@pytest.mark.parametrize("window", [1, 3, 70])
def test_flash_attention_short_windows_mask_the_leading_keys(cuda, window):
    """A window far shorter than the block's queries: most rows find the
    leading keys of the block's first tile masked (all but one for the
    last row at window 1), and the windows of the later queries start
    tiles after the first; the f32 softmax state must not let those
    masked keys in (the TPU kernel relies on a later real key to wipe
    them)."""
    for h, kh in ((1, 1), (10, 1), (8, 4)):
        q, k, v = _qkv(cuda, 2, 300, h, kh, 64, "float32", seed=window + h)
        got = flash_ops.flash_attention(q, k, v, window=window)
        _flash_close(got, flash_attention_ref(q, k, v, window=window),
                     "float32")
        if window == 1:     # each query sees only itself: out = v
            torch.testing.assert_close(
                got, v.repeat_interleave(h // kh, dim=2), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [1, 3, 70])
def test_flash_attention_short_windows_on_the_tensor_cores(cuda, window):
    """The short-window cases in bf16, through the tensor-core kernel:
    its per-tile mask and its -inf rule must keep the masked leading keys
    out, and at window 1 (p = 1 exactly, l = 1) out is v bit for bit."""
    for h, kh in ((1, 1), (10, 1), (8, 4)):
        q, k, v = _qkv(cuda, 2, 300, h, kh, 64, "bfloat16", seed=window + h)
        got = _flash_launch(q, k, v, window=window)
        _flash_close(got, flash_attention_ref(q, k, v, window=window),
                     "bfloat16")
        if window == 1:
            torch.testing.assert_close(
                got, v.repeat_interleave(h // kh, dim=2), rtol=0, atol=0)


@pytest.mark.cuda
def test_flash_attention_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v = _qkv(cuda, 1, 16, 2, 1, 32, "float32", seed=0)
    with pytest.raises(ValueError, match="forward only"):
        flash_ops.flash_attention(q.requires_grad_(), k, v)
    q = q.detach()
    with pytest.raises(ValueError, match="head_dim"):
        flash_ops.flash_attention(q[..., :16].contiguous(),
                                  k[..., :16].contiguous(),
                                  v[..., :16].contiguous())
    strided = lambda t: t.transpose(1, 2).contiguous().transpose(1, 2)  # noqa: E731
    with pytest.raises(ValueError, match="contiguous"):
        flash_ops.flash_attention(strided(q), strided(k), strided(v))
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        flash_ops.flash_attention(q.half(), k.half(), v.half())
    qb, kb, vb = (t[..., :16].contiguous().bfloat16() for t in (q, k, v))
    with pytest.raises(ValueError, match="head_dim"):
        flash_ops.flash_attention(qb, kb, vb)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d,dtype", [(4, 4096, 2560, "float32"),
                                         (3, 1000, 77, "float32"),
                                         (2, 17, 130, "bfloat16")])
def test_lru_scan_matches_plain_version_bitwise(cuda, b, s, d, dtype):
    g = torch.Generator(device=cuda).manual_seed(s + d)
    a = torch.sigmoid(torch.randn((b, s, d), generator=g, device=cuda))
    bb = torch.randn((b, s, d), generator=g, device=cuda) * 0.2
    a, bb = a.to(getattr(torch, dtype)), bb.to(getattr(torch, dtype))
    before = scan_ops.lru_scan.launches
    got = scan_ops.lru_scan(a, bb)
    torch.cuda.synchronize()
    assert scan_ops.lru_scan.launches == before + 1
    assert got.dtype == a.dtype
    assert torch.equal(got, lru_scan_ref(a, bb))


@pytest.mark.cuda
def test_lru_scan_rejects_grad(cuda):
    a = torch.rand((1, 4, 8), device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="forward only"):
        scan_ops.lru_scan(a, a.detach())
