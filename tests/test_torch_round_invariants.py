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
    assert len(lines) == 1 and lines[0].startswith("round 2: loss_complex=")


def test_nan_client_is_excluded():
    shards = make_shards()
    shards[3] = dict(shards[3])
    shards[3]["images"] = np.full_like(shards[3]["images"], np.nan)
    t = _port(shards)
    m = t.run_round()
    assert m["n_valid"] == 3.0
    assert all(bool(torch.isfinite(x).all())
               for x in tree_leaves(t.server.complex))


@pytest.mark.parametrize("wire", [
    dict(comm_dtype="int8"),
    dict(comm_dtype="bfloat16", stochastic_rounding=True,
         error_feedback=True),
    dict(comm_dtype="int8", topk_frac=1 / 14, stochastic_rounding=True,
         error_feedback=True)])
def test_nan_client_is_excluded_on_a_lossy_wire_and_keeps_its_ef_row(wire):
    shards = make_shards()
    shards[3] = dict(shards[3])
    shards[3]["images"] = np.full_like(shards[3]["images"], np.nan)
    t = _port(shards, **wire)
    assert t.run_round()["n_valid"] == 3.0
    assert all(bool(torch.isfinite(x).all())
               for x in tree_leaves(t.server.complex))
    if t.ef_store is not None:
        rows = t.ef_store.gather(np.arange(4))
        assert not rows[3].any()             # the NaN client's row stays 0
        assert all(bool(rows[i].any()) for i in range(3))
        assert t.client_state.column("ef_scale")[3] == 0.0


def test_compressed_trainer_runs_on_cuda_unless_asked(monkeypatch):
    fed = FedConfig(**dict(ROUND, comm_dtype="int8", topk_frac=1 / 14,
                           stochastic_rounding=True, error_feedback=True))
    assert FederatedTrainer(ResNetAdapter(10, NARROW), fed, make_shards(),
                            device="cpu").device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FederatedTrainer(ResNetAdapter(10, NARROW), fed, make_shards())


def test_trainer_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FederatedTrainer(ResNetAdapter(10, NARROW), FedConfig(**ROUND),
                         make_shards())


def test_train_cli_builds_a_musicgen_trainer_and_needs_a_device(
        monkeypatch):
    """``--arch musicgen-large --reduced --device cpu`` builds a trainer
    on codebook streams (one per codebook, as the reference's CLI draws
    them) whose round runs; without a card the CLI raises."""
    from repro_torch.launch import train
    trainer, test = train.build_trainer(train.build_parser().parse_args(
        ["--model", "lm", "--arch", "musicgen-large", "--reduced",
         "--device", "cpu", "--clients", "4", "--participation", "0.5",
         "--data-points", "16", "--seq-len", "8", "--batch-size", "4",
         "--local-epochs", "1"]))
    nc = trainer.adapter.cfg.n_codebooks
    assert nc == 2 and tuple(test["tokens"].shape) == (64, 9, nc)
    m = trainer.run_round()
    assert m["n_valid"] == 2 and np.isfinite(m["loss_complex"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--rounds", "0", "--clients", "4", "--data-points",
                    "8"])


def test_train_parser_has_the_reference_flags():
    """The port's CLI takes exactly the reference's 40 flags, plus
    ``--device``."""
    from repro.launch.train import build_parser as ref_parser
    from repro_torch.launch import train
    flags = lambda ap: {s for a in ap._actions for s in a.option_strings
                        if s not in ("-h", "--help")}
    ref = flags(ref_parser())
    assert len(ref) == 40
    assert flags(train.build_parser()) == ref | {"--device"}


@pytest.mark.parametrize("wire", [dict(), dict(comm_dtype="bfloat16"),
                                  dict(comm_dtype="int8", quant_block=32),
                                  dict(comm_dtype="bfloat16", topk_frac=0.1),
                                  dict(topk_frac=0.1,
                                       agg_stream_dtype="bfloat16")])
def test_auto_cohort_chunk_budgets_the_wire_as_the_reference(wire):
    from test_torch_round import make_pair
    kw = dict(ROUND, n_devices=8, n_simple=4, cohort_chunk="auto",
              agg_memory_budget_mb=2.4e6 / 2**20, **wire)
    port, ref = make_pair(make_shards(32, 8), **kw)
    assert port.cohort_chunk == ref.cohort_chunk


def test_train_cli_runs_the_tree_engine_scaffold_and_uniform_sampling(
        capsys):
    from repro_torch.launch import train
    args = ["--device", "cpu", "--rounds", "1", "--clients", "4",
            "--participation", "0.5", "--data-points", "16",
            "--batch-size", "4", "--local-epochs", "1", "--eval-every", "0",
            "--agg-engine", "tree", "--variance-reduction", "scaffold",
            "--sample-uniform"]
    fed = train.build_trainer(train.build_parser().parse_args(args))[0].fed
    assert (fed.agg_engine, fed.variance_reduction, fed.sample_uniform) == \
        ("tree", "scaffold", True)
    assert len(train.main(args)) == 1
    # 4 rows of the full-width model, 178.8 MB: over the device threshold
    assert "control-variate store: host backend" in capsys.readouterr().out
