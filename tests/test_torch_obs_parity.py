"""The port's telemetry event stream against the reference's.

The same toy run (``torch_obs_cases``: ``tests/test_obs.py``'s adapter, 8
clients of 8 points, batch 4, the reference's minibatch order through
``ReferenceSchedule`` and, on the compressed wire, its random bits through
``ReferenceBits``) goes through both packages with telemetry on: two
rounds of ``run(eval_every=1)``.  The streams are compared as events:
the reference's JAX-only events (``trace_lower``, ``compile``)
are removed and its ``seq`` renumbered; then every event must have the
same kind, name, path, round, keys (in order) and attributes, and the same
spans a ``dur_s`` of ``None``.  The ``roofline`` ledger is compared by
kind, name, round and keys in order (the reference's ``xla_flops``, XLA's
own cost analysis, has no counterpart), never by value: the two walks
count different programs by design.  Bytes, counters, histograms and the
``run_config`` ledger are held exactly; loss and eval values at the round
parity tests' atol 1e-5; the ``log`` line's prefix, key order and
separators exactly and its ``.4f`` values within one printed unit plus
that atol (a value can round either way at a boundary).  Only ``t`` and
``dur_s`` (wall times) are not compared.

Also: both packages' ``render(summarize(...))`` give the same string for a
reference run's JSONL and for a port run's, and ``tools/obs_report.py``
(the reference's tool, unchanged) renders a port run's file and compares
it with a reference run's.
"""

import os
import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro.configs.base import FedConfig as RefFedConfig  # noqa: E402
from repro.core.federated import FederatedTrainer as RefTrainer  # noqa
from repro.obs import report as ref_report  # noqa: E402
from repro.obs import telemetry as ref_obs  # noqa: E402

from test_torch_round_schedule import ReferenceSchedule  # noqa: E402
from test_torch_round_wire import ReferenceBits  # noqa: E402
from torch_obs_cases import FED, eval_batch, make_trainer, shards  # noqa

from repro_torch.obs import report as obs_report  # noqa: E402
from repro_torch.obs import telemetry as obslib  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_ONLY = ("trace_lower", "compile")
NO_VALUES = ("roofline",)     # keys compared, values not
NO_COUNTERPART = ("xla_flops",)
ATOL = 1e-5
NUMBER = re.compile(r"(-?\d+\.\d+|nan)")
# values compared at ATOL: losses and the eval ledger's metrics
APPROX = ("loss_simple", "loss_complex", "acc_simple", "acc_complex")


class RefToyAdapter:
    """``tests/test_obs.py``'s toy adapter."""

    def init(self, key):
        return {"a": jnp.zeros((4,), jnp.float32),
                "b": jnp.zeros((4,), jnp.float32)}

    def subnet_mask(self, params):
        return {"a": jnp.asarray(True), "b": jnp.asarray(False)}

    @staticmethod
    def _loss(params, batch):
        x = batch["x"]
        err_a = params["a"][None] - x
        err_b = params["b"][None] - 2.0 * x
        return jnp.mean(err_a ** 2) + jnp.mean(err_b ** 2)

    loss_simple = loss_complex = loss_side = _loss

    def evaluate(self, params, batch):
        return {"acc_simple": jnp.mean(params["a"]),
                "acc_complex": jnp.mean(params["b"])}


CASES = {
    "fedhen": dict(),
    "noside": dict(algorithm="noside"),
    "decouple": dict(algorithm="decouple"),
    "tree": dict(agg_engine="tree"),
    "int8": dict(comm_dtype="int8"),
    "compressed": dict(comm_dtype="int8", topk_frac=1 / 14,
                       stochastic_rounding=True, error_feedback=True),
    "scaffold": dict(variance_reduction="scaffold"),
    "uniform": dict(sample_uniform=True, participation=0.5),
    "async_lag1": dict(async_lag=1),
    "async_lag3": dict(async_lag=3),
    "nan_client": dict(chunk=1, poison=1),
}


def run_pair(case, port_sinks=(), ref_sinks=(), rounds=2):
    """The case's port and reference trainers, each run ``rounds`` rounds
    through ``run(eval_every=1)`` with a memory sink (plus the sinks
    given).  Returns (port trainer, port events, port log lines, reference
    trainer, reference events, reference log lines)."""
    kw = dict(CASES[case])
    chunk, poison = kw.pop("chunk", 2), kw.pop("poison", None)
    mem, ref_mem = obslib.MemorySink(), ref_obs.MemorySink()
    port = make_trainer(
        obslib.Telemetry([mem, *port_sinks]), chunk=chunk, poison=poison,
        schedule=ReferenceSchedule(0, FED["local_epochs"]),
        bits=ReferenceBits(0), **kw)
    cfg = dict(FED, cohort_chunk=chunk, **kw)
    ref = RefTrainer(RefToyAdapter(), RefFedConfig(**cfg),
                     [{"x": jnp.asarray(s["x"])}
                      for s in shards(poison=poison)],
                     telemetry=ref_obs.Telemetry([ref_mem, *ref_sinks]))
    lines, ref_lines = [], []
    port.run(rounds, eval_every=1, test_batch=eval_batch(),
             log=lines.append)
    ref.run(rounds, eval_every=1, test_batch={"x": jnp.zeros((4, 4))},
            log=ref_lines.append)
    return port, mem.events, lines, ref, ref_mem.events, ref_lines


def _close(a, b, atol) -> bool:
    if isinstance(a, float) and np.isnan(a):
        return isinstance(b, float) and np.isnan(b)
    return abs(a - b) <= atol


def assert_log_line(mine: str, theirs: str) -> None:
    """The text around the numbers (prefix, keys in order, separators)
    exactly; the numbers, printed ``.4f``, within one printed unit plus
    :data:`ATOL`."""
    a, b = NUMBER.split(mine), NUMBER.split(theirs)
    assert a[0::2] == b[0::2], (mine, theirs)
    for v, w in zip(a[1::2], b[1::2]):
        assert _close(float(v), float(w), 1e-4 + ATOL), (mine, theirs)


def _assert_values(name, values, ref_values):
    assert list(values) == list(ref_values), (name, values, ref_values)
    for k, v in values.items():
        w = ref_values[k]
        if name == "eval" and k in APPROX:
            assert _close(v, w, ATOL), (name, k, v, w)
        else:
            assert v == w, (name, k, v, w)


def assert_streams_match(events, ref_events) -> None:
    """The comparison of the module docstring."""
    ref_events = [e for e in ref_events if e["name"] not in JAX_ONLY]
    assert [e["seq"] for e in events] == list(range(len(events)))
    assert [(e["kind"], e["name"], e.get("path"), e["round"])
            for e in events] == \
        [(e["kind"], e["name"], e.get("path"), e["round"])
         for e in ref_events]
    for e, r in zip(events, ref_events):
        assert list(e) == list(r), (e, r)
        assert (e.get("dur_s") is None) == (r.get("dur_s") is None), (e, r)
        for k in e:
            if k in ("seq", "t", "dur_s"):
                continue
            if k == "values" and e["name"] in NO_VALUES:
                assert list(e[k]) == [v for v in r[k]
                                      if v not in NO_COUNTERPART], (e, r)
            elif k == "values":
                _assert_values(e["name"], e[k], r[k])
            elif k == "message":
                assert_log_line(e[k], r[k])
            else:
                assert e[k] == r[k], (k, e, r)


@pytest.mark.parametrize("case", list(CASES))
def test_event_stream_matches_reference(case):
    port, events, lines, ref, ref_events, ref_lines = run_pair(case)
    assert_streams_match(events, ref_events)
    assert len(lines) == len(ref_lines) == 2
    for mine, theirs in zip(lines, ref_lines):
        assert_log_line(mine, theirs)
    assert (port.total_bytes_down, port.total_bytes_up) == \
        (ref.total_bytes_down, ref.total_bytes_up)
    spans = {e["name"] for e in events if e["kind"] == "span"}
    assert {"round", "sample_gather", "execute"} <= spans


@pytest.mark.parametrize("eval_every", [1, 2])
def test_run_log_lines_match_reference(eval_every):
    """Telemetry off: ``run(log=...)`` hands both packages' callbacks the
    reference's ``round N: k=v, ...`` line, at the same rounds."""
    port = make_trainer(schedule=ReferenceSchedule(0, FED["local_epochs"]))
    ref = RefTrainer(RefToyAdapter(),
                     RefFedConfig(**dict(FED, cohort_chunk=2)),
                     [{"x": jnp.asarray(s["x"])} for s in shards()])
    lines, ref_lines = [], []
    port.run(2, eval_every=eval_every, test_batch=eval_batch(),
             log=lines.append)
    ref.run(2, eval_every=eval_every, test_batch={"x": jnp.zeros((4, 4))},
            log=ref_lines.append)
    assert [ln.partition(": ")[0] for ln in lines] == \
        [f"round {r}" for r in range(eval_every, 3, eval_every)]
    assert len(lines) == len(ref_lines)
    for mine, theirs in zip(lines, ref_lines):
        assert_log_line(mine, theirs)


@pytest.fixture(scope="module")
def run_logs(tmp_path_factory):
    """JSONL logs of the fedhen case: (port run's path, reference run's)."""
    d = tmp_path_factory.mktemp("obs")
    port_path, ref_path = str(d / "port.jsonl"), str(d / "ref.jsonl")
    port_sink, ref_sink = obslib.JsonlSink(port_path), \
        ref_obs.JsonlSink(ref_path)
    run_pair("fedhen", port_sinks=[port_sink], ref_sinks=[ref_sink])
    port_sink.close()
    ref_sink.close()
    return port_path, ref_path


@pytest.mark.parametrize("which", ["port", "reference"])
def test_render_equals_reference_render(run_logs, which):
    path = run_logs[0 if which == "port" else 1]
    events = obslib.read_jsonl(path)
    assert events == ref_obs.read_jsonl(path)
    for target, metric in ((None, "loss_complex"), (0.0, "acc_simple")):
        mine = obs_report.render(obs_report.summarize(
            events, target=target, target_metric=metric))
        theirs = ref_report.render(ref_report.summarize(
            events, target=target, target_metric=metric))
        assert mine == theirs
    assert obs_report.report_path(path) == ref_report.report_path(path)
    assert obs_report.compare_paths(*run_logs) == \
        ref_report.compare_paths(*run_logs)


def test_reference_tool_renders_a_port_run(run_logs):
    port_path, ref_path = run_logs
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    tool = str(ROOT / "tools" / "obs_report.py")
    proc = subprocess.run([sys.executable, tool, port_path],
                          capture_output=True, text=True, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == obs_report.report_path(port_path)
    assert "rounds: 2" in proc.stdout and "-- comm --" in proc.stdout
    proc = subprocess.run([sys.executable, tool, "--compare", ref_path,
                           port_path], capture_output=True, text=True,
                          env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == obs_report.compare_paths(ref_path,
                                                           port_path)
    assert "telemetry run comparison" in proc.stdout
