"""The port's training command line against the reference's, with
``--telemetry-out``, on the CPU.

Both ``repro_torch.launch.train`` and ``repro.launch.train`` run in this
process at a narrow ResNet configuration: PreActResNet18-GN at widths
(8, 16, 16, 16) on 16 x 16 synthetic CIFAR (both modules' adapter and
data generator swapped for the test), both from the port's initial
weights, 4 clients of 4 points at batch 4 (one SGD step a client, so the
minibatch order cannot matter), participation 1.0, ``--cohort-chunk
auto``, 2 rounds, evaluated each.  They print the same lines: the text
exactly, the numbers as ``test_torch_obs_parity.assert_log_line`` holds
them, with the wall-seconds figure, the run log's path and the port's
own lines (its byte split and device, its stores) set aside.  Their JSONL
files agree as the event-stream parity test holds them.
"""

import functools
import re

import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro.core.adapters import ResNetAdapter as RefAdapter  # noqa: E402
from repro.launch import train as ref_train  # noqa: E402

from test_torch_obs_parity import (assert_log_line,  # noqa: E402
                                   assert_streams_match)
from test_torch_round import NARROW, SIZE  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.core.adapters import ResNetAdapter  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.obs import telemetry as obslib  # noqa: E402

ARGS = ["--model", "resnet", "--rounds", "2", "--clients", "4",
        "--participation", "1.0", "--data-points", "16", "--batch-size",
        "4", "--local-epochs", "1", "--eval-every", "1", "--cohort-chunk",
        "auto"]
# lines only the port prints: its byte split and device, its stores
PORT_ONLY = re.compile(r"  [\d.]+ MB down, [\d.]+ MB up, on |"
                       r"(error-feedback|control-variate) store: ")
WALL = re.compile(r"rounds in \d+\.\ds")


def _narrow(monkeypatch):
    """Both CLIs at the narrow configuration, from the same weights."""
    start = ResNetAdapter(10, NARROW).init(torch.Generator().manual_seed(0),
                                           "cpu")
    ref_start = interop.to_reference(start)

    class PortNarrow(ResNetAdapter):
        def __init__(self, n_classes):
            super().__init__(n_classes, NARROW)

    class RefSameStart(RefAdapter):
        def init(self, key):
            return jax.tree.map(jnp.asarray, ref_start)

    for mod, adapter in ((train, PortNarrow), (ref_train, RefSameStart)):
        monkeypatch.setattr(mod, "ResNetAdapter", adapter)
        monkeypatch.setattr(mod, "synthetic_cifar", functools.partial(
            mod.synthetic_cifar, image_size=SIZE))


def _lines(out: str, path: str) -> list:
    return [WALL.sub("rounds in Ts", ln.replace(path, "RUN"))
            for ln in out.splitlines() if not PORT_ONLY.match(ln)]


def _masked(events: list) -> list:
    return [dict(e, message=WALL.sub("rounds in Ts", e["message"]))
            if e["kind"] == "log" else e for e in events]


def test_cli_prints_and_logs_what_the_reference_cli_does(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    _narrow(monkeypatch)
    port_path, ref_path = str(tmp_path / "p.jsonl"), str(tmp_path / "r.jsonl")
    history = train.main(ARGS + ["--device", "cpu", "--telemetry-out",
                                 port_path])
    port_out = capsys.readouterr().out
    ref_history = ref_train.main(ARGS + ["--telemetry-out", ref_path])
    ref_out = capsys.readouterr().out

    mine, theirs = _lines(port_out, port_path), _lines(ref_out, ref_path)
    assert len(mine) == len(theirs), (port_out, ref_out)
    for a, b in zip(mine, theirs):
        assert_log_line(a, b)
    assert sum(ln.startswith("[round ") for ln in mine) == 2
    assert mine[0].startswith("cohort_chunk=auto -> ")
    assert mine[-1] == "telemetry run log: RUN (render: python " \
        "tools/obs_report.py RUN)"
    assert [h["round"] for h in history] == \
        [h["round"] for h in ref_history] == [1, 2]

    events = _masked(obslib.read_jsonl(port_path))
    assert_streams_match(events, _masked(obslib.read_jsonl(ref_path)))
    assert [e["name"] for e in events if e["kind"] == "ledger"].count(
        "eval") == 2


def test_cli_without_telemetry_logs_nothing_to_a_file(tmp_path,
                                                      monkeypatch, capsys):
    """Without ``--telemetry`` the trainer is not instrumented: the
    CLI's lines still print, no span or ledger is built."""
    _narrow(monkeypatch)
    seen = []
    real = train.build_trainer

    def spy(args, telemetry=None):
        seen.append(telemetry)
        return real(args, telemetry=telemetry)

    monkeypatch.setattr(train, "build_trainer", spy)
    train.main(ARGS[:3] + ["1"] + ARGS[4:] + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert seen == [None]
    assert "[round    1] " in out and "telemetry run log" not in out
