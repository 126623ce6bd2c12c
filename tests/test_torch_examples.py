"""The port's examples beside the reference's: ``quickstart_torch.py``
has the reference quickstart's config, rounds, target, engine settings,
data and shards (the tokens bitwise), and its three algorithms run two
rounds each on the CPU and print the rounds-to-target table."""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro.data.federated import iid_split  # noqa: E402
from repro.data.synthetic import synthetic_lm  # noqa: E402

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def pair():
    return _load("quickstart"), _load("quickstart_torch")


def test_quickstart_settings_equal_the_reference(pair):
    ref, port = pair
    assert (port.ROUNDS, port.TARGET, port.ENGINE) == \
        (ref.ROUNDS, ref.TARGET, ref.ENGINE)
    want = dataclasses.asdict(ref.CFG)
    got = dataclasses.asdict(port.CFG)
    assert got == want
    fed = port.fed_config("decouple")
    assert (fed.n_devices, fed.n_simple, fed.participation, fed.rounds,
            fed.local_epochs, fed.lr, fed.batch_size, fed.seed) == \
        (20, 10, 0.2, ref.ROUNDS, 1, 0.1, 8, 0)


def test_quickstart_data_and_shards_equal_the_reference(pair):
    ref, port = pair
    # the reference quickstart's run() builds exactly these
    want = iid_split(synthetic_lm(400, 32, ref.CFG.vocab_size, seed=1),
                     20, seed=2)
    got = port.shards(port.fed_config("fedhen"))
    assert len(got) == len(want) == 20
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["tokens"], np.asarray(w["tokens"]))
        assert g["tokens"].dtype == np.asarray(w["tokens"]).dtype
    np.testing.assert_array_equal(
        port.test_batch()["tokens"],
        synthetic_lm(64, 32, ref.CFG.vocab_size, seed=99)["tokens"])


def test_quickstart_runs_two_rounds_on_the_cpu(pair, capsys):
    _, port = pair
    results = port.main(["--rounds", "2", "--device", "cpu"])
    assert [r["algorithm"] for r in results] == list(port.ALGORITHMS)
    for r in results:
        assert np.isfinite(r["final_acc_simple"])
        assert r["mbytes"] > 0
    out = capsys.readouterr().out
    assert "rounds->tgt" in out and "decouple" in out


def test_multipod_dryrun_example_on_a_reduced_config(capsys):
    """``multipod_dryrun_torch.py`` walks reduced gemma2-2b's decode step
    on ``meta`` at the 16 x 16 shape and prints the roofline terms.  The
    serve step runs over a model axis, so it is walked as one rank of a
    fake 16 x 16 mesh: its all-reduces give the collective term."""
    rec = _load("multipod_dryrun_torch").main(
        ["gemma2-2b", "decode_32k", "single", "--reduced"])
    assert rec["mesh"] == "16x16" and rec["chips"] == 256
    assert rec["t_collective"] > 0
    counts = rec["coll_breakdown"]["counts"]
    assert counts["all-reduce"] > 0 and sum(counts.values()) == \
        counts["all-reduce"]
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert rec["flops_per_chip"] > 0 and rec["t_memory"] > 0
    out = capsys.readouterr().out
    assert "t_collective  none" not in out and "bottleneck" in out
