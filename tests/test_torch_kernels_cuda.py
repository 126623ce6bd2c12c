"""The port's CUDA kernels against their plain PyTorch versions, on the card.

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
from repro_torch.kernels.masked_agg.ref import masked_agg_acc_ref  # noqa


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
