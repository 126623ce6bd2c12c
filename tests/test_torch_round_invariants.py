"""The port's own round invariants, with no reference run: chunking
invariance, NaN exclusion, ``run``'s history, the step count, and the
device rule at the trainer and the command line.  Setup as in
``test_torch_round.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro.configs.base import FedConfig as RefFedConfig  # noqa: E402

from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.core.adapters import ResNetAdapter  # noqa: E402
from repro_torch.core.federated import FederatedTrainer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_round import NARROW, ROUND, make_shards  # noqa: E402


def _port(shards, **kw):
    cfg = dict(ROUND, **kw)
    return FederatedTrainer(ResNetAdapter(10, NARROW), FedConfig(**cfg),
                            shards, device="cpu",
                            generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("algorithm", ["fedhen", "decouple"])
def test_round_is_invariant_to_chunking(algorithm):
    shards = make_shards(48, 6)
    kw = dict(n_devices=6, n_simple=3, batch_size=4, algorithm=algorithm)
    runs = []
    for chunk in (0, 1, 2):     # 2 pads each population of 3 with one slot
        t = _port(shards, cohort_chunk=chunk, **kw)
        runs.append((t.run_round(), t.run_round(), t))
    for m1, m2, t in runs[1:]:
        assert (m1, m2) == runs[0][:2]
        for a, b in zip(tree_leaves(t.server.complex),
                        tree_leaves(runs[0][2].server.complex)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("n_points,batch_size,epochs", [(4, 4, 1), (9, 4, 3),
                                                        (3, 8, 2)])
def test_local_step_count_matches_reference(n_points, batch_size, epochs):
    from repro.core.federated import local_step_count as ref_count
    from repro_torch.core.federated import local_step_count
    data = {"images": np.zeros((n_points, 2, 2, 3), np.float32)}
    kw = dict(batch_size=batch_size, local_epochs=epochs)
    stacked = {k: v[None] for k, v in data.items()}   # (k=1, N_i, ...)
    assert local_step_count(data, FedConfig(**kw)) == \
        ref_count(stacked, RefFedConfig(**kw))


def test_run_records_each_round_and_its_evaluation():
    shards, test = make_shards(), make_shards(32, 1)[0]
    lines = []
    history = _port(shards).run(2, eval_every=2, test_batch=test,
                                log=lines.append)
    again = _port(shards)
    rounds = [again.run_round(), again.run_round()]
    assert [h["round"] for h in history] == [1, 2]
    assert "acc_simple" not in history[0]
    assert {k: history[1][k] for k in rounds[1]} == rounds[1]
    assert history[1]["acc_complex"] == again.evaluate(test)["acc_complex"]
    assert len(lines) == 1 and lines[0].startswith("round 2: ")


def test_nan_client_is_excluded():
    shards = make_shards()
    shards[3] = dict(shards[3])
    shards[3]["images"] = np.full_like(shards[3]["images"], np.nan)
    t = _port(shards)
    m = t.run_round()
    assert m["n_valid"] == 3.0
    assert all(bool(torch.isfinite(x).all())
               for x in tree_leaves(t.server.complex))


def test_trainer_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FederatedTrainer(ResNetAdapter(10, NARROW), FedConfig(**ROUND),
                         make_shards())


def test_train_cli_rejects_unported_flags_and_needs_a_device(monkeypatch):
    from repro_torch.launch import train
    with pytest.raises(SystemExit):
        train.build_parser().parse_args(["--comm-dtype", "int8"])
    with pytest.raises(SystemExit):
        train.build_parser().parse_args(["--model", "lm"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--rounds", "0", "--clients", "4", "--data-points",
                    "8"])
