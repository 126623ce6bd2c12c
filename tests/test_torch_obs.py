"""The port's telemetry (``repro_torch.obs``): ``tests/test_obs.py``'s
fourteen tests run against the port — registry semantics, the span tree
and ledgers of two sync rounds, the padding and NaN counters, async lag-1
staleness and cache counters, the null-sink bit parity at lag 0 and 1,
the log line, the JSONL round trip and report, rounds-to-target in both
directions, and the comparison.  The toy trainer is
``torch_obs_cases``'s (``test_obs.py``'s adapter in torch), on the CPU.

Where the reference's run differs by design, the test says so: the port
has no trace or XLA compile, and on the CPU no kernel library to load, so
a CPU run emits no ``trace_lower`` / ``compile`` span and its report's
``compile_s`` is 0 (the reference asserts ``> 0``); the reference's
``roofline`` ledger has no counterpart yet.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from torch_obs_cases import eval_batch, make_trainer  # noqa: E402

from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.core.federated import FederatedTrainer  # noqa: E402
from repro_torch.obs import report as obs_report  # noqa: E402
from repro_torch.obs import telemetry as obslib  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
import torch_obs_cases as cases  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _max_abs_diff(a, b):
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


# ---------------------------------------------------------------------------
# Registry semantics
# ---------------------------------------------------------------------------

def test_span_paths_nest():
    mem = obslib.MemorySink()
    tel = obslib.Telemetry([mem])
    with tel.span("outer"):
        with tel.span("inner", tag=3):
            tel.counter("c", 1)
        tel.point_span("logical")
    paths = [e.get("path") for e in mem.of_kind("span")]
    # spans emit on exit: inner closes first, then the logical point
    # span, then outer
    assert paths == ["outer/inner", "outer/logical", "outer"]
    inner = mem.named("inner")[0]
    assert inner["dur_s"] >= 0 and inner["tag"] == 3
    assert mem.named("logical")[0]["dur_s"] is None
    assert mem.named("c")[0]["value"] == 1
    assert [e["seq"] for e in mem.events] == list(range(len(mem.events)))


def test_disabled_telemetry_emits_nothing():
    mem = obslib.MemorySink()
    tel = obslib.Telemetry([mem], enabled=False)
    with tel.span("x"):
        tel.counter("c", 1)
        tel.ledger("l", {"a": 1})
        tel.log("hi")
        tel.point_span("p")
    assert mem.events == []
    assert not obslib.NOOP.enabled  # the module singleton stays disabled


def test_jsonable_coerces_array_scalars():
    """numpy scalars, torch scalars and 0-d tensors go through
    ``.item()``, so the events hold plain JSON values."""
    assert obslib.jsonable(np.float32(1.5)) == 1.5
    assert obslib.jsonable(np.int64(7)) == 7
    assert obslib.jsonable({"k": (np.float32(2.0),)}) == {"k": [2.0]}
    assert obslib.jsonable(torch.tensor(1.5)) == 1.5
    assert obslib.jsonable(torch.tensor(7, dtype=torch.int64)) == 7
    assert obslib.jsonable(torch.tensor(True)) is True
    assert obslib.jsonable({"k": (torch.tensor(2.0, dtype=torch.bfloat16),)}
                           ) == {"k": [2.0]}
    json.dumps(obslib.jsonable({"a": torch.zeros(()),
                                "b": np.zeros(())}))  # must not raise


# ---------------------------------------------------------------------------
# Sync engine: span tree, counters, byte ledger
# ---------------------------------------------------------------------------

def test_sync_two_round_span_tree_and_ledgers():
    mem = obslib.MemorySink()
    tr = make_trainer(obslib.Telemetry([mem]))
    tr.run_round()
    tr.run_round()

    # k=4 per population at chunk 2 -> 2 chunks each, 4 folds/round
    want_phases = (["round/sample_gather", "round/execute",
                    "round/broadcast"]
                   + [f"round/train-chunk[{t}]" for t in range(4)]
                   + ["round/fold", "round/finalize", "round"])
    for r in (0, 1):
        paths = [e["path"] for e in mem.of_kind("span") if e["round"] == r]
        assert paths == want_phases, (r, paths)
    # no trace or compile: the CPU loads no kernel library (on the card the
    # first round's library load is a compile span)
    assert not (mem.named("trace_lower") or mem.named("compile"))
    # the roofline ledger rides the first round (the toy adapter has no
    # matmuls, so assert on memory traffic, not flops)
    roof = mem.named("roofline")
    assert len(roof) == 1 and roof[0]["round"] == 0
    assert roof[0]["values"]["hbm_bytes"] > 0

    # chunk attributes: population split in stream order, staleness absent
    chunks0 = [e for e in mem.of_kind("span")
               if e["round"] == 0 and e["name"].startswith("train-chunk")]
    assert [c["population"] for c in chunks0] == \
        ["simple", "simple", "complex", "complex"]
    assert all("staleness" not in c for c in chunks0)

    # client health: clean run, no exclusions, chunk 2 divides k=4
    assert [e["value"] for e in mem.named("nan_excluded_devices")] == [0, 0]
    assert [e["value"] for e in mem.named("padding_weight0_clients")] == \
        [0, 0]

    # byte ledger: EXACT equality with the trainer's measured accounting
    ledgers = [e["values"] for e in mem.named("comm_bytes")]
    assert len(ledgers) == 2
    for i, led in enumerate(ledgers, start=1):
        assert led["down"] == tr.bytes_down_per_round
        assert led["up"] == tr.bytes_up_per_round
        assert led["cum_down"] == i * tr.bytes_down_per_round
        assert led["cum_up"] == i * tr.bytes_up_per_round
    assert ledgers[-1]["cum_total"] == tr.total_bytes

    # run_config ledger carries the engine's own attrs, dtypes spelled as
    # the reference spells them
    cfg = mem.named("run_config")[0]["values"]
    assert cfg["engine"] == "sync" and cfg["agg_engine"] == "flat"
    assert cfg["k_simple"] == 4 and cfg["n_chunks_complex"] == 2
    assert cfg["agg_stream_dtype"] == "float32"
    assert cfg["wire_dtype"] == "float32"


def test_padding_counter_counts_weight0_slots():
    """k=3 per population at chunk 2 -> one zero-validity padding slot
    per population per round."""
    mem = obslib.MemorySink()
    fed = FedConfig(n_devices=6, n_simple=3, participation=1.0,
                    local_epochs=1, lr=0.1, batch_size=4,
                    algorithm="fedhen", seed=0, cohort_chunk=2)
    tr = FederatedTrainer(cases.ToyAdapter(), fed, cases.shards(6),
                          device="cpu", telemetry=obslib.Telemetry([mem]))
    tr.run_round()
    assert mem.named("padding_weight0_clients")[0]["value"] == 2


def test_nan_exclusion_counter():
    """A NaN-poisoned client shows up as nan_excluded_devices > 0 in the
    round it is sampled (participation=1.0 -> every round)."""
    mem = obslib.MemorySink()
    tr = make_trainer(obslib.Telemetry([mem]), chunk=1, poison=1)
    tr.run_round()
    tr.run_round()
    values = [e["value"] for e in mem.named("nan_excluded_devices")]
    assert values == [1, 1]
    for leaf in tree_leaves(tr.server.complex):
        assert bool(torch.isfinite(leaf).all())


# ---------------------------------------------------------------------------
# Async engine: staleness histogram, cache counters, version-aware bytes
# ---------------------------------------------------------------------------

def test_async_lag1_span_tree_and_health():
    mem = obslib.MemorySink()
    tr = make_trainer(obslib.Telemetry([mem]), async_lag=1)
    tr.run_round()
    tr.run_round()

    rounds = [e for e in mem.named("round")]
    assert [e["engine"] for e in rounds] == ["async", "async"]
    assert [e["lag"] for e in rounds] == [1, 1]

    # staleness histogram matches the fold schedule exactly:
    # round 0 clamps to all-fresh; round 1 has one 1-stale chunk
    hists = [e["values"] for e in mem.named("staleness_hist")]
    assert hists == [{"0": 4}, {"0": 3, "1": 1}]
    chunks1 = [e for e in mem.of_kind("span")
               if e["round"] == 1 and e["name"].startswith("train-chunk")]
    assert [c["staleness"] for c in chunks1] == [1, 0, 0, 0]

    # version-cache counters: round 0 all misses (8 clients); round 1
    # the stale chunk's clients (chunk=2) re-use their held version
    assert [e["value"] for e in mem.named("version_cache_miss")] == [8, 6]
    assert [e["value"] for e in mem.named("version_cache_hit")] == [0, 2]

    # byte ledger equals the engine's version-aware accounting
    eng = tr.async_engine
    led = [e["values"] for e in mem.named("comm_bytes")]
    assert led[-1]["down"] == eng.last_bytes_down
    assert led[-1]["up"] == eng.last_bytes_up
    assert led[-1]["cum_down"] == tr.total_bytes_down
    assert led[-1]["cum_total"] == tr.total_bytes
    # the stale chunk saved exactly its clients' downloads in round 1
    assert led[1]["down"] == led[0]["down"] - 2 * tr.per_simple_bytes


# ---------------------------------------------------------------------------
# The observation contract: sinks never steer the run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("async_lag", [0, 1])
def test_noop_sink_run_bit_identical_to_telemetry_off(async_lag):
    off = make_trainer(None, async_lag=async_lag)
    on = make_trainer(obslib.Telemetry([obslib.NullSink()]),
                      async_lag=async_lag)
    m_off = [off.run_round() for _ in range(2)]
    m_on = [on.run_round() for _ in range(2)]
    assert m_off == m_on
    assert _max_abs_diff(off.server.complex, on.server.complex) == 0.0
    assert off.total_bytes == on.total_bytes


# ---------------------------------------------------------------------------
# run() logging + JSONL -> report pipeline
# ---------------------------------------------------------------------------

def test_run_log_line_format_bit_identical(capsys):
    """The log line routed through a StdoutSink prints exactly the string
    the log callback receives."""
    legacy = []
    off = make_trainer(None)
    off.run(2, eval_every=1, test_batch=eval_batch(), log=legacy.append)
    on = make_trainer(obslib.Telemetry([obslib.StdoutSink()]))
    capsys.readouterr()
    on.run(2, eval_every=1, test_batch=eval_batch())
    printed = capsys.readouterr().out.splitlines()
    assert printed == legacy
    assert all(line.startswith("round ") for line in printed)


def test_jsonl_roundtrip_and_report(tmp_path):
    path = str(tmp_path / "run.jsonl")
    tel = obslib.Telemetry([obslib.JsonlSink(path)])
    tr = make_trainer(tel)
    tr.run(2, eval_every=1, test_batch=eval_batch())
    tel.close()

    events = obslib.read_jsonl(path)
    assert events, "JSONL run log is empty"
    kinds = {e["kind"] for e in events}
    assert kinds >= {"span", "counter", "ledger", "log"}

    summary = obs_report.summarize(events)
    assert summary["rounds"]["n_rounds"] == 2
    assert summary["comm"]["cum_total"] == tr.total_bytes
    assert summary["health"]["nan_excluded_devices"] == 0
    # 0, where the reference asserts > 0: a CPU run has no compile span
    assert summary["rounds"]["compile_s"] == 0
    assert summary["rounds"]["execute_median_s"] > 0
    # eval ledgers feed the trajectory; acc metrics count as reached
    # at-or-ABOVE the target, so an unreachable ceiling stays None
    summary_t = obs_report.summarize(events, target=1e9,
                                     target_metric="acc_simple")
    assert summary_t["progress"]["rounds_to_target"] is None
    rendered = obs_report.render(summary)
    for needle in ("telemetry run report", "-- rounds --", "-- comm --",
                   "-- client health --"):
        assert needle in rendered
    assert "rounds: 2" in obs_report.report_path(path)


def test_report_rounds_to_target():
    """rounds_to_target: first eval round at or under the threshold."""
    events = [
        {"kind": "ledger", "name": "eval", "round": 1,
         "values": {"loss_complex": 0.9}},
        {"kind": "ledger", "name": "eval", "round": 2,
         "values": {"loss_complex": 0.4}},
        {"kind": "ledger", "name": "eval", "round": 3,
         "values": {"loss_complex": 0.2}},
    ]
    s = obs_report.summarize(events, target=0.5)
    assert s["progress"]["rounds_to_target"] == 2
    assert s["progress"]["final"] == 0.2
    s2 = obs_report.summarize(events, target=0.05)
    assert s2["progress"]["rounds_to_target"] is None


def test_report_rounds_to_target_acc_direction():
    """acc* metrics flip the comparison: reached at-or-ABOVE the target."""
    events = [
        {"kind": "ledger", "name": "eval", "round": 1,
         "values": {"acc_simple": 0.1}},
        {"kind": "ledger", "name": "eval", "round": 2,
         "values": {"acc_simple": 0.3}},
        {"kind": "ledger", "name": "eval", "round": 3,
         "values": {"acc_simple": 0.6}},
    ]
    s = obs_report.summarize(events, target=0.25,
                             target_metric="acc_simple")
    assert s["progress"]["rounds_to_target"] == 2
    s2 = obs_report.summarize(events, target=0.9,
                              target_metric="acc_simple")
    assert s2["progress"]["rounds_to_target"] is None


def test_compare_summaries_and_render():
    """--compare diff: config differences listed, per-section a/b/delta
    rows computed B - A, rounds-to-target delta included."""
    def events(vr, down, loss2):
        return [
            {"kind": "ledger", "name": "run_config",
             "values": {"algorithm": "fedhen", "variance_reduction": vr}},
            {"kind": "span", "name": "round", "round": 0, "dur_s": 0.5},
            {"kind": "span", "name": "round", "round": 1, "dur_s": 0.5},
            {"kind": "ledger", "name": "comm_bytes", "round": 1,
             "values": {"down": down, "up": down, "cum_down": 2 * down,
                        "cum_up": 2 * down, "cum_total": 4 * down}},
            {"kind": "ledger", "name": "eval", "round": 1,
             "values": {"loss_complex": 0.9}},
            {"kind": "ledger", "name": "eval", "round": 2,
             "values": {"loss_complex": loss2}},
        ]

    a = obs_report.summarize(events("none", 100.0, 0.6), target=0.5)
    b = obs_report.summarize(events("scaffold", 200.0, 0.4), target=0.5)
    cmp = obs_report.compare_summaries(a, b)
    assert cmp["config_diff"] == {
        "variance_reduction": {"a": "none", "b": "scaffold"}}
    assert cmp["comm"]["bytes_down_per_round"]["delta"] == 100.0
    assert cmp["comm"]["cum_total"]["delta"] == 400.0
    # A never reaches 0.5; B reaches it at round 2
    rt = cmp["progress"]["rounds_to_target"]
    assert rt["a"] is None and rt["b"] == 2 and rt["delta"] is None
    assert cmp["progress"]["final"]["delta"] == pytest.approx(-0.2)
    assert cmp["phases"]["round"]["delta"] == pytest.approx(0.0)

    rendered = obs_report.render_compare(cmp)
    for needle in ("telemetry run comparison", "config differences",
                   "variance_reduction: A=none  B=scaffold",
                   "-- comm --", "rounds_to_target"):
        assert needle in rendered


def test_compare_paths_cli(tmp_path):
    """The file-level entry point diffs two JSONL logs end to end, and so
    does the port's command line, ``python -m repro_torch.obs.report``."""
    def write(path, down):
        with open(path, "w") as f:
            for e in (
                    {"kind": "ledger", "name": "run_config",
                     "values": {"algorithm": "fedhen"}},
                    {"kind": "ledger", "name": "comm_bytes", "round": 0,
                     "values": {"down": down, "up": down,
                                "cum_total": 2 * down}}):
                f.write(json.dumps(e) + "\n")

    pa, pb = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    write(pa, 100.0)
    write(pb, 300.0)
    out = obs_report.compare_paths(pa, pb)
    assert "bytes_down_per_round" in out and "+200" in out

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.report", "--compare", pa,
         pb], capture_output=True, text=True, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == out
