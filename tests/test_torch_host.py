"""Port parity of the framework-free host modules, the config and the wire.

The port keeps its own copies of ``repro``'s numpy-only modules; these
tests hold each copy to the original on the same inputs, at exact
equality.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro.configs.base import FedConfig as RefFedConfig  # noqa: E402
from repro.core import comm as ref_comm  # noqa: E402
from repro.core import sampling as ref_sampling  # noqa: E402
from repro.data import federated as ref_fed_data  # noqa: E402
from repro.data import synthetic as ref_synthetic  # noqa: E402

from repro_torch import device as tdevice  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.core import comm, sampling  # noqa: E402
from repro_torch.data import federated as fed_data  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402


@pytest.mark.parametrize("uniform", [False, True])
@pytest.mark.parametrize("n_devices,n_simple,p", [(100, 50, 0.1),
                                                  (20, 7, 0.35),
                                                  (1000, 300, 0.02)])
def test_sampler_plans_identical(uniform, n_devices, n_simple, p):
    kw = dict(n_devices=n_devices, n_simple=n_simple, participation=p,
              seed=11, uniform=uniform)
    mine, ref = sampling.CohortSampler(**kw), ref_sampling.CohortSampler(**kw)
    assert (mine.cap_simple, mine.cap_complex) == (ref.cap_simple,
                                                   ref.cap_complex)
    for r in range(5):
        a, b = mine.plan(r), ref.plan(r)
        for field in ("simple_ids", "complex_ids", "simple_real",
                      "complex_real"):
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field))


@pytest.mark.parametrize("n,k", [(10, 10), (10, 4), (10_000, 7)])
def test_draw_without_replacement_identical(n, k):
    a = sampling.draw_without_replacement(sampling.round_rng(3, 2), n, k)
    b = ref_sampling.draw_without_replacement(ref_sampling.round_rng(3, 2),
                                              n, k)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("image_size", [8, 32])
def test_synthetic_cifar_identical(image_size):
    a = synthetic.synthetic_cifar(40, 10, seed=5, image_size=image_size)
    b = ref_synthetic.synthetic_cifar(40, 10, seed=5, image_size=image_size)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("split", ["iid", "dirichlet"])
def test_splits_identical(split):
    data = ref_synthetic.synthetic_cifar(200, 10, seed=2, image_size=8)
    if split == "iid":
        a = fed_data.iid_split(data, 8, seed=4)
        b = ref_fed_data.iid_split(data, 8, seed=4)
    else:
        a = fed_data.dirichlet_split(data, 8, 0.3, seed=4)
        b = ref_fed_data.dirichlet_split(data, 8, 0.3, seed=4)
    assert len(a) == len(b)
    for sa, sb in zip(a, b):
        for k in sb:
            np.testing.assert_array_equal(sa[k], sb[k])


def test_fedconfig_fields_and_defaults_match():
    mine = {f.name: f.default for f in dataclasses.fields(FedConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(RefFedConfig)}
    assert mine == ref


@pytest.mark.parametrize("bad", [
    dict(algorithm="fedavg"), dict(agg_engine="ring"),
    dict(agg_block_n=100), dict(agg_stream_dtype="float16"),
    dict(cohort_chunk="half"), dict(comm_dtype="float16"),
    dict(quant_block=48), dict(topk_frac=0.0),
    dict(stochastic_rounding=True), dict(error_feedback=True),
    dict(async_lag=-1), dict(async_staleness="exp"),
    dict(async_decay=-1.0), dict(variance_reduction="fedvr"),
    dict(state_store_backend="disk"),
    dict(variance_reduction="scaffold", lr=0.0),
])
def test_fedconfig_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError):
        RefFedConfig(**bad)
    with pytest.raises(ValueError):
        FedConfig(**bad)


@pytest.mark.parametrize("knob", [
    dict(comm_dtype="int8"), dict(comm_dtype="bfloat16"),
    dict(topk_frac=0.5), dict(comm_dtype="int8", stochastic_rounding=True),
    dict(comm_dtype="int8", error_feedback=True), dict(async_lag=2),
    dict(variance_reduction="scaffold"), dict(agg_engine="tree"),
    dict(sample_uniform=True),
])
def test_fedconfig_unported_knobs_raise_naming_the_knob(knob):
    RefFedConfig(**knob)                     # valid in the reference
    with pytest.raises(NotImplementedError, match=next(iter(knob))
                       if len(knob) == 1 else None):
        FedConfig(**knob)


@pytest.mark.parametrize("n", [1, 676_171, 11_173_461])
def test_f32_wire_bytes_match_reference(n):
    assert comm.wire_bytes(comm.WireSpec(), n) == \
        ref_comm.wire_bytes(ref_comm.WireSpec(), n) == 4 * n


def test_unported_wires_raise():
    with pytest.raises(NotImplementedError):
        comm.wire_bytes(comm.WireSpec("int8"), 128)
    with pytest.raises(NotImplementedError):
        comm.broadcast_roundtrip(comm.WireSpec("bfloat16"), None, {})


def test_device_rule(monkeypatch):
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tdevice.resolve_device(dev)
    with pytest.raises(ValueError):
        tdevice.resolve_device("meta")


def test_port_imports_nothing_of_jax_or_the_reference():
    import pathlib
    import re
    root = pathlib.Path(__file__).resolve().parents[1]
    files = list((root / "src" / "repro_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    bad = re.compile(r"^\s*(import jax|from jax|import repro\b(?!_torch)|"
                     r"from repro[. ](?!_torch))", re.M)
    offenders = [str(f) for f in files if bad.search(f.read_text())]
    assert not offenders, offenders
