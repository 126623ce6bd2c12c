"""Port parity of the RG-LRU scan (K6's plain version).

The same seeded numpy ``a``, ``b`` go through the reference's sequential
oracle (``lru_scan_ref``), its Pallas kernel in interpret mode (as
``tests/test_kernels.py`` runs it on the CPU), the associative scan of its
model path (``rglru_scan.ops.lru_scan`` off the TPU, ``rglru.lru_scan``)
and the port's ``ops.lru_scan`` on CPU tensors, at f32 rtol = atol =
1e-5.  The sequential oracle rounds the same products and sums in the
same order as the port's plain version, so that pair is held bitwise.  The
model's scan, whose gates each framework computes with its own ``exp``, is
held to the bound of ``tests/test_torch_lru_scan_gated.py`` (the gates'
one-ulp differences carried through the recurrence) plus that tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.kernels.rglru_scan.kernel import lru_scan_pallas  # noqa: E402
from repro.kernels.rglru_scan.ops import lru_scan as ref_ops_scan  # noqa: E402
from repro.kernels.rglru_scan.ref import lru_scan_ref as ref_seq  # noqa: E402
from repro.models import rglru as ref_rglru  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.kernels.rglru_scan import ops  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import lru_scan_ref  # noqa: E402
from repro_torch.models import rglru  # noqa: E402
from test_torch_lru_scan_gated import (  # noqa: E402
    assert_within_gate_bound, scan_gate_bound)

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(b, s, d, seed):
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.normal(size=(b, s, d))))).astype(
        np.float32)
    bb = (rng.normal(size=(b, s, d)) * 0.2).astype(np.float32)
    return a, bb


@pytest.mark.parametrize("b,s,d,block_s,block_d", [
    (2, 64, 256, 16, 128),
    (1, 128, 512, 32, 512),
    (3, 40, 77, 8, 77),          # ragged S and D
])
def test_plain_scan_matches_reference(b, s, d, block_s, block_d):
    a, bb = _inputs(b, s, d, seed=b * s + d)
    got = ops.lru_scan(torch.from_numpy(a), torch.from_numpy(bb)).numpy()
    assert ops.lru_scan.launches == 0           # the CPU launches nothing
    seq = np.asarray(ref_seq(jnp.asarray(a), jnp.asarray(bb)))
    np.testing.assert_array_equal(got, seq)
    pallas = lru_scan_pallas(jnp.asarray(a), jnp.asarray(bb),
                             block_s=block_s, block_d=block_d,
                             interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    assoc = ref_ops_scan(jnp.asarray(a), jnp.asarray(bb))
    np.testing.assert_allclose(got, np.asarray(assoc), **TOL)


def test_plain_scan_bf16_rounds_output_once():
    a, bb = _inputs(2, 33, 40, seed=7)
    at = torch.from_numpy(a).bfloat16()
    bt = torch.from_numpy(bb).bfloat16()
    got = ops.lru_scan(at, bt)
    assert got.dtype == torch.bfloat16
    want = lru_scan_ref(at.float(), bt.float()).bfloat16()
    assert torch.equal(got, want)


@pytest.mark.parametrize("with_y0", [False, True])
def test_model_scan_matches_reference(with_y0):
    cfg = ref_reduced("recurrentgemma-2b")
    ref_p = ref_rglru.init_rglru(jax.random.PRNGKey(1), cfg)
    rng = np.random.default_rng(2)
    # gates away from 0 so the recurrence carries information
    ref_p = dict(ref_p, w_r=jnp.asarray(rng.normal(size=128), jnp.float32),
                 w_i=jnp.asarray(rng.normal(size=128), jnp.float32))
    x = rng.normal(size=(2, 48, 128)).astype(np.float32)
    y0 = rng.normal(size=(2, 128)).astype(np.float32) if with_y0 else None
    want = ref_rglru.lru_scan(ref_p, jnp.asarray(x),
                              None if y0 is None else jnp.asarray(y0))
    p = interop.from_reference(jax.tree.map(np.asarray, ref_p))
    got = rglru.lru_scan(p, torch.from_numpy(x),
                         None if y0 is None else torch.from_numpy(y0))
    # where a -> 1 the frameworks' one-ulp exp differences are amplified
    # in b: held to that bound carried through the scan, as the gated
    # entry's test holds it (tests/test_torch_lru_scan_gated.py)
    assert_within_gate_bound(got.numpy(), np.asarray(want),
                             scan_gate_bound(ref_p, x, y0), TOL)


@pytest.mark.parametrize("lam", [-3.0, 0.5, 25.0, 40.0])
def test_gates_use_jax_softplus(lam):
    """``F.softplus`` switches to x above 20; the gates use logaddexp."""
    cfg = ref_reduced("recurrentgemma-2b")
    ref_p = ref_rglru.init_rglru(jax.random.PRNGKey(0), cfg)
    ref_p = dict(ref_p, lam=jnp.full((128,), lam, jnp.float32),
                 w_r=jnp.full((128,), 0.3, jnp.float32))
    x = np.random.default_rng(0).normal(size=(1, 3, 128)).astype(np.float32)
    wa, wb = ref_rglru._gates(ref_p, jnp.asarray(x))
    ga, gb = rglru._gates(interop.from_reference(
        jax.tree.map(np.asarray, ref_p)), torch.from_numpy(x))
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), **TOL)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), **TOL)


def test_wrapper_rejects_bad_inputs():
    a, bb = (torch.from_numpy(t) for t in _inputs(1, 4, 8, seed=0))
    with pytest.raises(ValueError, match="forward only"):
        ops.lru_scan(a.requires_grad_(), bb)
    a = a.detach()
    with pytest.raises(ValueError):
        ops.lru_scan(a, bb[:, :3])
    with pytest.raises(ValueError):
        ops.lru_scan(a, bb.double())
    with pytest.raises(ValueError, match="contiguous"):
        ops.lru_scan(a.transpose(1, 2), bb.transpose(1, 2))
