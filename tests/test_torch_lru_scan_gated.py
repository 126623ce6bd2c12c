"""K6's gated entry on the CPU: its plain version, the model path through
it, its launch plan, and its wrapper's checks.

``ops.lru_scan_gated`` computes the RG-LRU layer's recurrence from its
input: the gates (``models/rglru._gates``), then the scan.  On CPU tensors
it runs ``ref.lru_scan_gated_ref``, a copy of ``_gates`` followed by
``lru_scan_ref``, so the model's CPU path is bitwise what it was when it
ran ``_gates`` and ``ops.lru_scan``; it is held to the reference's
``repro.models.rglru.lru_scan`` (an associative scan, so another order of
sums): its scan on the reference's gates at f32 rtol = atol = 1e-5, its
gates within what one ulp of the frameworks' ``exp`` allows, and its
output within that gate bound carried through the recurrence.  ``ops.scan_plan`` is the kernel's launch
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


# -- against the reference: the scan tight, the gates to what exp allows ----
#
# Where a -> 1, b = sqrt(1 - exp(2 log a)) (i x) is ill-conditioned: the
# two frameworks' f32 ``exp`` differ in the last bit on some inputs, and
# one ulp of exp(2 log a) near 1 moves 1 - exp(2 log a) by ulp(1) / 2,
# which the sqrt turns into |db| ~ ulp(1) / (4 sqrt(1 - a^2)) |i x|.  So
# the port is held to the reference in three parts: its scan on the
# REFERENCE's gates at the flat f32 tolerance; its gates to one ulp in a
# and to that derivative in b; and its output to that gate bound carried
# through the recurrence (see _error_bound).

ULP1 = float(np.spacing(np.float32(1.0)))    # 2**-23
# k in |db| <= k ulp(1) / (2 sqrt(max(1 - a^2, 1e-12))) |i x|: one ulp of
# exp(2 log a) below 1 is ulp(1) / 2, so k = 1 already has a factor 2; the
# other roundings of b on either side (i's exp, the sqrt, two products:
# about 4 half-ulps of b <= |i x|) take k to 4 where a is small
K_ULP = 4.0


def _reference_gates(ref_p, x):
    ra, rb = ref_rglru._gates(ref_p, jnp.asarray(x))
    return np.array(ra), np.array(rb)


def _b_bound(ref_p, x, ra):
    """Per-element bound on |b - b_ref| (f64): one ulp of exp(2 log a)
    through the sqrt, times |i x|; a from the reference."""
    xf = x.astype(np.float64)
    w_i, b_i = (np.asarray(ref_p[k], np.float64) for k in ("w_i", "b_i"))
    i = 1.0 / (1.0 + np.exp(-(w_i * xf + b_i)))
    u = np.maximum(1.0 - ra.astype(np.float64) ** 2, 1e-12)
    return K_ULP * ULP1 / (2.0 * np.sqrt(u)) * np.abs(i * xf)


def _fold_y0(a, b, y0):
    """b with y0 folded into the first step in f32, as the port folds it."""
    if y0 is None:
        return b
    b = b.copy()
    b[:, 0] = b[:, 0] + a[:, 0] * y0
    return b


def _error_bound(ra, rb, db, y0):
    """Bound on |y - y_ref| from the gates' bounds, carried through the
    recurrence: y_t - y'_t = a_t (y_{t-1} - y'_{t-1}) + (a_t - a'_t)
    y'_{t-1} + (b_t - b'_t), so e_t = a_t e_{t-1} + spacing(a_t)
    |y_{t-1}| + db_t, with a_t (1 + ulp(1)) for the second-order term,
    y from the reference's gates in f64.  Below the cruder S max|db|,
    since every a <= 1.  y0's product with a_1 is the first step's
    spacing(a_1) |y0| term."""
    a = ra.astype(np.float64)
    b = rb.astype(np.float64)
    sp = np.spacing(np.abs(ra)).astype(np.float64)
    y = np.zeros(a[:, 0].shape) if y0 is None else y0.astype(np.float64)
    e = np.zeros_like(y)
    out = np.empty_like(a)
    for t in range(a.shape[1]):
        e = a[:, t] * (1.0 + ULP1) * e + sp[:, t] * np.abs(y) + db[:, t]
        y = a[:, t] * y + b[:, t]
        out[:, t] = e
    return out


def _hold_to_reference(ref_p, x, y0, a, b, got, want):
    """The port's gates (a, b) and output ``got`` (the scan of them)
    against the reference's gates and its output ``want``; raises
    AssertionError where they part by more than the derivation allows."""
    ra, rb = _reference_gates(ref_p, x)
    # 1. the scan, tight: the port's scan on the reference's own gates
    on_ref = lru_scan_ref(torch.from_numpy(ra),
                          torch.from_numpy(_fold_y0(ra, rb, y0)))
    np.testing.assert_allclose(on_ref.numpy(), want, **TOL)
    # 2. the gates: a within one f32 ulp, b within one ulp of exp(2 log a)
    assert np.all(np.abs(a.astype(np.float64) - ra)
                  <= np.spacing(np.abs(ra))), "a beyond one ulp"
    db = _b_bound(ref_p, x, ra)
    assert np.all(np.abs(b.astype(np.float64) - rb) <= db), \
        "b beyond one ulp of exp(2 log a)"
    # 3. the output: that bound through the recurrence, plus the flat
    # tolerance of the scan's order of sums
    assert_within_gate_bound(got, want, _error_bound(ra, rb, db, y0), TOL)


def scan_gate_bound(ref_p, x, y0=None):
    """The bound on |y - y_ref| that the gates' one-ulp differences allow
    for the recurrence over ``x`` (B, S, Dr) from ``y0``, with the
    reference's gate parameters ``ref_p``: for other tests of the same
    arithmetic."""
    ra, rb = _reference_gates(ref_p, x)
    return _error_bound(ra, rb, _b_bound(ref_p, x, ra), y0)


def assert_within_gate_bound(got, want, bound, tol):
    """|got - want| <= bound + atol + rtol |want|, element by element."""
    err = np.abs(np.asarray(got, np.float64) - want)
    assert np.all(err <= bound + tol["atol"] + tol["rtol"] * np.abs(want)), \
        f"output beyond the gate bound: {float(np.max(err - bound))}"


def _reference_case(seed, b, s, with_y0):
    """The reduced recurrentgemma layer's gate parameters, drawn by the
    reference (w_r, b_r, w_i, b_i away from their zero init), x and y0."""
    cfg = ref_reduced("recurrentgemma-2b")
    ref_p = ref_rglru.init_rglru(jax.random.PRNGKey(seed), cfg)
    dr = ref_p["w_r"].shape[0]
    rng = np.random.default_rng(seed)
    ref_p = dict(ref_p, **{k: jnp.asarray(rng.normal(size=dr), jnp.float32)
                           for k in ("w_r", "b_r", "w_i", "b_i")})
    x = rng.normal(size=(b, s, dr)).astype(np.float32)
    y0 = rng.normal(size=(b, dr)).astype(np.float32) if with_y0 else None
    return ref_p, x, y0


@pytest.mark.parametrize("with_y0", [False, True])
@pytest.mark.parametrize("seed,b,s", [(1, 2, 48), (4, 1, 130), (9, 3, 17)])
def test_gated_entry_matches_reference(with_y0, seed, b, s):
    """``ops.lru_scan_gated`` (and the model's ``lru_scan`` through it)
    against the reference's ``rglru.lru_scan`` on the same params: the
    scan at TOL on the reference's gates, the gates to one ulp of
    ``exp``, the output to that bound carried through the scan."""
    ref_p, x, y0 = _reference_case(seed, b, s, with_y0)
    want = np.asarray(ref_rglru.lru_scan(
        ref_p, jnp.asarray(x), None if y0 is None else jnp.asarray(y0)))
    p = interop.from_reference(jax.tree.map(np.asarray, ref_p))
    y0_t = None if y0 is None else torch.from_numpy(y0)
    got = ops.lru_scan_gated(torch.from_numpy(x), p["w_r"], p["b_r"],
                             p["w_i"], p["b_i"], _c(p), y0_t)
    # the entry's output is the scan of the port's gates, bitwise
    a, bb = (t.numpy() for t in rglru._gates(p, torch.from_numpy(x)))
    assert torch.equal(got, lru_scan_ref(
        torch.from_numpy(a), torch.from_numpy(_fold_y0(a, bb, y0))))
    _hold_to_reference(ref_p, x, y0, a, bb, got.numpy(), want)
    model = rglru.lru_scan(p, torch.from_numpy(x), y0_t)
    assert torch.equal(model, got)


def _wrong_gates(p, x, wrong):
    """``rglru._gates`` with one fault: c = -7.9 softplus(lam), no input
    gate, or sqrt(1 - a) for sqrt(1 - a^2)."""
    xf = x.float()
    r = torch.sigmoid(p["w_r"] * xf + p["b_r"])
    i = torch.sigmoid(p["w_i"] * xf + p["b_i"])
    lam = p["lam"]
    c = (7.9 if wrong == "c=7.9" else 8.0) * torch.logaddexp(
        lam, torch.zeros_like(lam))
    log_a = -c * r
    a = torch.exp(log_a)
    u = 1.0 - (a if wrong == "sqrt(1-a)" else torch.exp(2.0 * log_a))
    b = torch.sqrt(torch.clamp_min(u, 1e-12)) * (
        xf if wrong == "no input gate" else i * xf)
    return a, b


@pytest.mark.parametrize("wrong", ["c=7.9", "no input gate", "sqrt(1-a)"])
@pytest.mark.parametrize("seed,b,s", [(1, 2, 48), (9, 3, 17)])
def test_gate_bound_rejects_a_wrong_gate(wrong, seed, b, s):
    """The bound above is no wider than it must be: a port with a wrong
    gate fails both its gate check and, fed through the port's own scan,
    its output check, on the same cases."""
    ref_p, x, y0 = _reference_case(seed, b, s, with_y0=True)
    want = np.asarray(ref_rglru.lru_scan(ref_p, jnp.asarray(x),
                                         jnp.asarray(y0)))
    p = interop.from_reference(jax.tree.map(np.asarray, ref_p))
    a, bb = (t.numpy() for t in _wrong_gates(p, torch.from_numpy(x), wrong))
    got = lru_scan_ref(torch.from_numpy(a),
                       torch.from_numpy(_fold_y0(a, bb, y0))).numpy()
    with pytest.raises(AssertionError, match="beyond one ulp"):
        _hold_to_reference(ref_p, x, y0, a, bb, got, want)
    # the output check alone: the right gates' bound against the wrong y
    with pytest.raises(AssertionError, match="gate bound"):
        assert_within_gate_bound(got, want, scan_gate_bound(ref_p, x, y0),
                                 TOL)


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
