"""K6's gated entry on the CPU: its plain version, the model path through
it, its launch plan, and its wrapper's checks.

``ops.lru_scan_gated`` computes the RG-LRU layer's recurrence from its
input: the gates (``models/rglru._gates``), then the scan.  On CPU tensors
it runs ``ref.lru_scan_gated_ref``, a copy of ``_gates`` followed by
``lru_scan_ref``, so the model's CPU path is bitwise what it was when it
ran ``_gates`` and ``ops.lru_scan``; it is held to the reference's
``repro.models.rglru.lru_scan`` (an associative scan, so another order of
sums) at f32 rtol = atol = 1e-5.  ``ops.scan_plan`` is the kernel's launch
for both entries, checked here for coverage and shared memory; the kernel
itself runs only on the card (``tests/test_torch_kernels_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.models import rglru as ref_rglru  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.kernels.rglru_scan import ops  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import (  # noqa: E402
    lru_scan_gated_ref, lru_scan_ref)
from repro_torch.models import rglru  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
SMEM_LIMIT = 232_448         # shared bytes a block may take on an H100
SM_SMEM = 233_472            # an SM's shared bytes; 1 KB a block reserved


def _params(d, seed):
    """One layer's gate parameters: lam as ``init_rglru`` draws it, the
    gate weights and biases away from the init's zeros."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.9, 0.999, size=d)
    lam = np.log(np.expm1(-np.log(u) / 8.0))
    p = {k: torch.from_numpy(rng.normal(size=d).astype(np.float32))
         for k in ("w_r", "b_r", "w_i", "b_i")}
    p["lam"] = torch.from_numpy(lam.astype(np.float32))
    return p, rng


def _c(p):
    lam = p["lam"]
    return -8.0 * torch.logaddexp(lam, torch.zeros_like(lam))


def _before(p, x, y0):
    """The model's CPU path before the gated entry: ``_gates``, y0 folded
    into the first step, ``ops.lru_scan`` (``lru_scan_ref`` on the CPU),
    the cast to x's dtype."""
    a, b = rglru._gates(p, x)
    if y0 is not None:
        b[:, 0] = b[:, 0] + a[:, 0] * y0.float()
    return lru_scan_ref(a, b).to(x.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_y0", [False, True])
@pytest.mark.parametrize("b,s,d", [(2, 33, 40), (3, 65, 77)])
def test_gated_ref_equals_gates_then_scan(dtype, with_y0, b, s, d):
    p, rng = _params(d, seed=b * s + d)
    x = torch.from_numpy(rng.normal(size=(b, s, d)).astype(np.float32)).to(
        getattr(torch, dtype))
    y0 = (torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
          if with_y0 else None)
    got = lru_scan_gated_ref(x, p["w_r"], p["b_r"], p["w_i"], p["b_i"],
                             _c(p), y0)
    assert got.dtype == x.dtype
    assert torch.equal(got, _before(p, x, y0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_y0", [False, True])
def test_model_scan_on_cpu_is_bitwise_what_it_was(dtype, with_y0):
    p, rng = _params(96, seed=3)
    x = torch.from_numpy(rng.normal(size=(2, 50, 96)).astype(np.float32)).to(
        getattr(torch, dtype))
    y0 = (torch.from_numpy(rng.normal(size=(2, 96)).astype(np.float32))
          if with_y0 else None)
    before = (ops.lru_scan.launches, ops.lru_scan_gated.launches)
    got = rglru.lru_scan(p, x, y0)
    assert (ops.lru_scan.launches, ops.lru_scan_gated.launches) == before
    assert torch.equal(got, _before(p, x, y0))


@pytest.mark.parametrize("with_y0", [False, True])
@pytest.mark.parametrize("seed,b,s", [(1, 2, 48), (4, 1, 130), (9, 3, 17)])
def test_gated_entry_matches_reference(with_y0, seed, b, s):
    """``ops.lru_scan_gated`` (and the model's ``lru_scan`` through it)
    against the reference's ``rglru.lru_scan`` on the same params."""
    cfg = ref_reduced("recurrentgemma-2b")
    ref_p = ref_rglru.init_rglru(jax.random.PRNGKey(seed), cfg)
    dr = ref_p["w_r"].shape[0]
    rng = np.random.default_rng(seed)
    ref_p = dict(ref_p, **{k: jnp.asarray(rng.normal(size=dr), jnp.float32)
                           for k in ("w_r", "b_r", "w_i", "b_i")})
    x = rng.normal(size=(b, s, dr)).astype(np.float32)
    y0 = rng.normal(size=(b, dr)).astype(np.float32) if with_y0 else None
    want = np.asarray(ref_rglru.lru_scan(
        ref_p, jnp.asarray(x), None if y0 is None else jnp.asarray(y0)))
    p = interop.from_reference(jax.tree.map(np.asarray, ref_p))
    y0_t = None if y0 is None else torch.from_numpy(y0)
    got = ops.lru_scan_gated(torch.from_numpy(x), p["w_r"], p["b_r"],
                             p["w_i"], p["b_i"], _c(p), y0_t)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    model = rglru.lru_scan(p, torch.from_numpy(x), y0_t)
    assert torch.equal(model, got)


PLAN_SHAPES = [(4, 4096, 2560), (3, 1000, 77), (2, 17, 130), (2, 129, 129),
               (2, 129, 260), (3, 65, 33), (1, 300, 8), (3, 1, 64),
               (1, 1, 1), (5, 64, 32)]


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,d", PLAN_SHAPES)
def test_scan_plan_covers_every_channel_and_step(gated, dtype, b, s, d):
    dt = getattr(torch, dtype)
    tl = ops.GATED if gated else ops.PLAIN
    plan = ops.scan_plan(b, s, d, dt, gated=gated)
    # the kernel's block -> (batch, stripe) map and its tiles of time
    covered = {(blk // plan.stripes, (blk % plan.stripes) * tl.stripe + c)
               for blk in range(plan.grid) for c in range(tl.stripe)}
    assert {(i, j) for i in range(b) for j in range(d)} <= covered
    assert all(j < d + tl.stripe - 1 for _, j in covered)   # no spare stripe
    assert plan.tiles * tl.tile >= s > (plan.tiles - 1) * tl.tile
    assert plan.grid == b * plan.stripes
    assert plan.threads <= 1024 and plan.threads % 32 == 0
    assert plan.smem_bytes <= SMEM_LIMIT
    elt = 4 if dtype == "float32" else 2
    box = tl.tile * tl.stripe
    assert plan.smem_bytes == (tl.stages * (1 if gated else 2) * box * elt
                               + tl.ab_stages * 2 * box * 4
                               + 8 * (2 * tl.stages + 2 * tl.ab_stages)
                               + 128)
    # TMA only where its boxes and row strides describe the tensor
    assert plan.tma == ((d * elt) % 16 == 0 and d >= tl.stripe
                        and s >= tl.tile)
    assert not ops.scan_plan(b, s, d, dt, gated=gated, aligned=False).tma


@pytest.mark.parametrize("gated,tiling", [
    (False, ops.Tiling(stripe=32, tile=64, stages=4)),
    (False, ops.Tiling(stripe=256, tile=8, stages=6)),
    (True, ops.Tiling(stripe=64, tile=32, stages=3, ab_stages=3,
                      gate_warps=4))])
@pytest.mark.parametrize("b,s,d", PLAN_SHAPES[:5])
def test_scan_plan_takes_another_tiling(monkeypatch, gated, tiling, b, s,
                                       d):
    """A build of an edited copy of the kernel is planned from the tiling
    it reports, put in the entry's place (as ``launch/tune_scan.py``
    does)."""
    monkeypatch.setattr(ops, "GATED" if gated else "PLAIN", tiling)
    plan = ops.scan_plan(b, s, d, torch.float32, gated=gated)
    assert plan.stripes == -(-d // tiling.stripe)
    assert plan.tiles == -(-s // tiling.tile)
    assert plan.threads == tiling.stripe + 32 + 32 * tiling.gate_warps
    box = tiling.tile * tiling.stripe
    assert plan.smem_bytes == (tiling.stages * (1 if gated else 2) * box * 4
                               + tiling.ab_stages * 2 * box * 4
                               + 8 * (2 * tiling.stages
                                      + 2 * tiling.ab_stages) + 128)
    assert plan.tma == (d % 4 == 0 and d >= tiling.stripe
                        and s >= tiling.tile)


def test_scan_plan_at_the_path_shape():
    """recurrentgemma-2b's prefill: both entries on TMA; the gated entry
    three blocks an SM (its kernel's launch bound), all 320 at once."""
    plain = ops.scan_plan(4, 4096, 2560, torch.float32)
    assert plain.tma and plain.grid == 4 * 2560 // ops.PLAIN.stripe
    for dtype in (torch.bfloat16, torch.float32):
        gated = ops.scan_plan(4, 4096, 2560, dtype, gated=True)
        assert gated.tma and gated.grid == 320 and gated.tiles == 64
    gated = ops.scan_plan(4, 4096, 2560, torch.bfloat16, gated=True)
    assert 3 * (gated.smem_bytes + 1024) <= SM_SMEM
    assert 3 * 132 >= gated.grid


def test_scan_plan_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.scan_plan(1, 4, 8, torch.float16)
    with pytest.raises(ValueError, match="no launch"):
        ops.scan_plan(0, 4, 8, torch.float32, gated=True)


def _gated_args(b=2, s=4, d=8, seed=0):
    p, rng = _params(d, seed)
    x = torch.from_numpy(rng.normal(size=(b, s, d)).astype(np.float32))
    return [x, p["w_r"], p["b_r"], p["w_i"], p["b_i"], _c(p), None]


def test_gated_wrapper_rejects_bad_inputs_and_launches_nothing_on_cpu():
    before = (ops.lru_scan.launches, ops.lru_scan_gated.launches)
    args = _gated_args()
    assert ops.lru_scan_gated(*args).shape == (2, 4, 8)
    grad = list(args)
    grad[2] = grad[2].clone().requires_grad_()
    with pytest.raises(ValueError, match="forward only"):
        ops.lru_scan_gated(*grad)
    with pytest.raises(ValueError, match="forward only"):
        ops.lru_scan_gated(args[0].clone().requires_grad_(), *args[1:])
    with pytest.raises(ValueError, match=r"\(B, S, D\)"):
        ops.lru_scan_gated(args[0][0], *args[1:])
    with pytest.raises(ValueError, match=r"\(B, S, D\)"):
        ops.lru_scan_gated(args[0].half(), *args[1:])
    for bad in (args[1][:7], args[1].double(), args[1].bfloat16()):
        with pytest.raises(ValueError, match="float32"):
            ops.lru_scan_gated(args[0], bad, *args[2:])
    for y0 in (torch.zeros(2, 7), torch.zeros(1, 8),
               torch.zeros(2, 8, dtype=torch.bfloat16)):
        with pytest.raises(ValueError, match="y0"):
            ops.lru_scan_gated(*args[:6], y0)
    with pytest.raises(ValueError, match="contiguous"):
        ops.lru_scan_gated(args[0].transpose(0, 1).contiguous().transpose(
            0, 1), *args[1:])
    strided = torch.zeros(16)[::2]
    with pytest.raises(ValueError, match="contiguous"):
        ops.lru_scan_gated(args[0], strided, *args[2:])
    with pytest.raises(ValueError, match="device"):
        ops.lru_scan_gated(args[0].to("meta"), *args[1:])
    assert (ops.lru_scan.launches, ops.lru_scan_gated.launches) == before
