"""Port parity of the language models' building blocks and configs.

The same seeded numpy inputs go through ``repro.models.common`` /
``repro.models.mlp`` and their ports.  f32 at rtol = atol = 1e-5 (the two
frameworks' transcendental functions and reductions differ by a few
ulps); RoPE is checked at positions up to 8192, where torch's f32
``10000 ** e`` differs from XLA's in one entry of 128 at head_dim 256 by
one ulp, which moves an angle by about 2.4e-7 rad.  bf16 results are held
to one bf16 rounding (2**-8 relative): where the f32 values straddle a
rounding boundary, the two frameworks' last-bit differences in the f32
arithmetic can round them to neighbouring bf16 values.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro import configs as ref_configs  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro.models import mlp as ref_mlp  # noqa: E402

from repro_torch import configs, interop  # noqa: E402
from repro_torch.models import common, mlp  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2.0 ** -8, atol=2.0 ** -8)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("arch", configs.PORTED)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_copies_match_reference(arch, reduced):
    get = "get_reduced" if reduced else "get_config"
    ref = getattr(ref_configs, get)(arch)
    port = getattr(configs, get)(arch)
    as_dict = lambda c: {f.name: getattr(c, f.name)  # noqa: E731
                         for f in dataclasses.fields(c)}
    ref_d, port_d = as_dict(ref), as_dict(port)
    ref_d["pattern"] = [dataclasses.astuple(s) for s in ref.pattern]
    port_d["pattern"] = [dataclasses.astuple(s) for s in port.pattern]
    # the two packages' MoEConfig and StubFrontend are different classes:
    # compare fields
    for key in ("moe", "frontend"):
        ref_d[key] = ref_d[key] and dataclasses.asdict(ref_d[key])
        port_d[key] = port_d[key] and dataclasses.asdict(port_d[key])
    assert ref_d == port_d
    for prop in ("resolved_head_dim", "resolved_d_rnn", "period",
                 "n_periods", "n_remainder", "resolved_exit_layer",
                 "exit_period"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    assert port.param_count() == ref.param_count()
    assert port.simple_param_count() == ref.simple_param_count()
    assert port.active_param_count() == ref.active_param_count()
    assert port.torch_param_dtype() == getattr(torch, ref.param_dtype)


def test_full_width_param_counts():
    assert configs.get_config("recurrentgemma-2b").param_count() \
        == 2_658_600_960
    assert configs.get_config("gemma2-2b").param_count() == 2_614_224_384


def test_every_arch_is_ported_and_unknown_is_keyerror():
    """The zoo is complete: every name the reference knows resolves, to
    its full and its reduced config; an unknown name is a ``KeyError``, as
    in the reference."""
    assert configs.PORTED == configs.ARCH_NAMES == ref_configs.ARCH_NAMES
    for name in configs.ARCH_NAMES:
        assert configs.get_config(name).name == name
        assert configs.get_reduced(name).name == name
    for get in (configs.get_config, configs.get_reduced):
        with pytest.raises(KeyError):
            get("no-such-arch")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 256])
def test_rmsnorm_matches_reference(dtype, d):
    rng = np.random.default_rng(d)
    x = rng.normal(1.0, 3.0, size=(2, 5, d)).astype(np.float32)
    scale = rng.normal(size=d).astype(np.float32) * 0.3
    xj = jnp.asarray(x).astype(dtype)
    want = ref_common.apply_rmsnorm({"scale": jnp.asarray(scale)}, xj, 1e-6)
    got = common.apply_rmsnorm({"scale": torch.from_numpy(scale)},
                               interop.from_reference(np.asarray(xj)), 1e-6)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               **(TOL if dtype == "float32" else BF16))


@pytest.mark.parametrize("cap", [0.0, 30.0, 50.0])
def test_softcap_matches_reference(cap):
    x = np.random.default_rng(1).normal(0, 60, size=(4, 33)).astype(
        np.float32)
    np.testing.assert_allclose(
        common.softcap(torch.from_numpy(x), cap).numpy(),
        np.asarray(ref_common.softcap(jnp.asarray(x), cap)), **TOL)


@pytest.mark.parametrize("dh", [32, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_reference_up_to_8192(dh, dtype):
    rng = np.random.default_rng(dh)
    x = rng.normal(size=(2, 64, 3, dh)).astype(np.float32)
    pos = np.sort(rng.integers(0, 8193, size=64)).astype(np.int32)
    pos[-1] = 8192
    xj = jnp.asarray(x).astype(dtype)
    # jitted, as every step of the reference runs it (its frequencies
    # folded on the host)
    want = jax.jit(ref_common.apply_rope, static_argnums=2)(
        xj, jnp.asarray(pos), 10000.0)
    got = common.apply_rope(interop.from_reference(np.asarray(xj)),
                            torch.from_numpy(pos), 10000.0)
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               **(TOL if dtype == "float32" else BF16))
    # (B, S) positions take the same path
    got2 = common.apply_rope(interop.from_reference(np.asarray(xj)),
                             torch.from_numpy(np.stack([pos, pos])), 10000.0)
    assert torch.equal(got, got2)


@pytest.mark.parametrize("theta", [10000.0, 500000.0, 1e6])
@pytest.mark.parametrize("dh", [32, 64, 112, 128, 256])
def test_rope_frequencies_are_the_jitted_reference_bitwise(dh, theta):
    want = np.asarray(jax.jit(lambda: ref_common.rope_frequencies(
        dh, theta))())
    got = common.rope_frequencies(dh, theta).numpy()
    assert np.array_equal(got, want)


def test_rope_frequencies_within_one_ulp():
    want = np.asarray(ref_common.rope_frequencies(256, 10000.0))
    got = common.rope_frequencies(256, 10000.0).numpy()
    ulp = np.spacing(np.abs(want))
    assert np.all(np.abs(got - want) <= ulp)


@pytest.mark.parametrize("dtype,d", [("float32", 128), ("bfloat16", 2560),
                                     ("bfloat16", 2304)])
def test_embedding_matches_reference_with_its_scale_rounding(dtype, d):
    rng = np.random.default_rng(d)
    table = jnp.asarray(rng.normal(size=(50, d)).astype(np.float32)
                        ).astype(dtype)
    tokens = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    want = ref_common.apply_embedding({"table": table}, jnp.asarray(tokens))
    got = common.apply_embedding(
        {"table": interop.from_reference(np.asarray(table))},
        torch.from_numpy(tokens).long())
    assert got.dtype == getattr(torch, dtype)
    # one multiply by the same rounded scale: bitwise
    np.testing.assert_array_equal(got.float().numpy(), _np(want))
    if dtype == "bfloat16" and d == 2560:
        # sqrt(2560) = 50.596... rounds to 50.5 in bf16, in both packages
        one = {"table": torch.ones((1, d), dtype=torch.bfloat16)}
        assert float(common.apply_embedding(one, torch.zeros(1).long())[0, 0]
                     ) == 50.5


def test_unembedding_matches_reference():
    rng = np.random.default_rng(5)
    table = rng.normal(size=(97, 64)).astype(np.float32)
    h = rng.normal(size=(2, 3, 64)).astype(np.float32)
    want = ref_common.apply_unembedding({"table": jnp.asarray(table)},
                                        jnp.asarray(h))
    got = common.apply_unembedding({"table": torch.from_numpy(table)},
                                   torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("glu", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_matches_reference(glu, dtype):
    cfg = configs.get_reduced("gemma2-2b").with_overrides(mlp_glu=glu,
                                                          param_dtype=dtype)
    ref_cfg = ref_configs.get_reduced("gemma2-2b").with_overrides(
        mlp_glu=glu, param_dtype=dtype)
    ref_p = ref_mlp.init_mlp(jax.random.PRNGKey(3), ref_cfg)
    x = np.random.default_rng(3).normal(size=(2, 5, cfg.d_model)).astype(
        np.float32)
    xj = jnp.asarray(x).astype(dtype)
    want = ref_mlp.apply_mlp(ref_p, xj)
    got = mlp.apply_mlp(interop.from_reference(
        jax.tree.map(np.asarray, ref_p)), interop.from_reference(
        np.asarray(xj)))
    tol = TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.float().numpy(), _np(want), **tol)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 101).astype(np.float32)
    np.testing.assert_allclose(mlp.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))),
                               **TOL)


def test_interop_carries_bf16_exactly_both_ways():
    x = jnp.asarray(np.random.default_rng(0).normal(size=(3, 4)) * 100
                    ).astype(jnp.bfloat16)
    t = interop.from_reference({"w": np.asarray(x)})["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), _np(x))
    back = interop.to_reference({"w": t})["w"]
    assert back.dtype == np.asarray(x).dtype
    np.testing.assert_array_equal(back.view(np.uint16),
                                  np.asarray(x).view(np.uint16))
