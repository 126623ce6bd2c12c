"""The port's checkpoints (``repro_torch.checkpoint.checkpoint``): tree
and flat round trips, the refusals (shape, layout, sampler, missing
sidecars), the verbatim path, legacy server checkpoints, resume equal to
an uninterrupted run bitwise (sync, async, SCAFFOLD, error feedback) and
the train command line's ``--checkpoint`` / ``--resume``; checkpoints
crossing between the packages are in ``test_torch_checkpoint_cross.py``.

The port-only cases train ``attn4`` (``torch_lm_cases``) on 4 clients at
participation 0.5.  The flat checkpoint's lossy wires are held to the
reference test's bounds (bf16 within ``8e-3 max|x|``, int8 within
``max|x| / 127``).
"""

import dataclasses
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from torch_lm_cases import config_pair  # noqa: E402

from repro_torch.checkpoint import checkpoint as ck  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.core import comm, flatten  # noqa: E402
from repro_torch.core.adapters import LMAdapter  # noqa: E402
from repro_torch.core.federated import FederatedTrainer  # noqa: E402
from repro_torch.data.federated import iid_split  # noqa: E402
from repro_torch.data.synthetic import synthetic_lm  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


def tiny_trainer(algorithm="fedhen", **kw):
    cfg = config_pair("attn4")[1]
    fed = FedConfig(n_devices=4, n_simple=2, participation=0.5,
                    local_epochs=1, batch_size=4, algorithm=algorithm, **kw)
    data = synthetic_lm(32, 16, cfg.vocab_size, seed=1)
    shards = [{"tokens": s["tokens"]} for s in iid_split(data, 4, seed=2)]
    return FederatedTrainer(LMAdapter(cfg), fed, shards, device="cpu",
                            generator=torch.Generator().manual_seed(0))


def assert_same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


# -- trees -------------------------------------------------------------------

def test_tree_roundtrip_with_bf16_at_the_verbatim_path(tmp_path):
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.bfloat16) * 1.5,
                  "d": torch.arange(7, dtype=torch.int32)},
            "list": [torch.zeros((2, 2)), torch.ones(1)]}
    path = str(tmp_path / "tree.ckpt")          # no .npz suffix
    ck.save_tree(path, tree, {"round": 7})
    assert os.path.exists(path) and not os.path.exists(path + ".npz")
    restored, meta = ck.restore_tree(path, tree)
    assert meta == {"round": 7}
    assert_same(restored, tree)
    with np.load(path) as data:                 # the reference's layout
        assert sorted(data.files) == ["__dtypes__", "__meta__", "a", "b/c",
                                      "b/d", "list/[0]", "list/[1]"]
        assert data["b/c"].dtype == np.uint16


def test_shape_mismatch_and_missing_leaf_rejected(tmp_path):
    path = str(tmp_path / "c.npz")
    ck.save_tree(path, {"a": torch.ones(3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.restore_tree(path, {"a": torch.ones(4)})
    with pytest.raises(KeyError, match="missing leaf b"):
        ck.restore_tree(path, {"a": torch.ones(3), "b": torch.ones(1)})


def test_flat_checkpoint_f32_exact_decouple_carries_host(tmp_path):
    for algorithm in ("fedhen", "decouple"):
        tr = tiny_trainer(algorithm)
        tr.run_round()
        path = str(tmp_path / f"flat_{algorithm}.ckpt")
        ck.save_server_flat(path, tr.server, tr.layout)
        assert os.path.exists(path)
        tr2 = tiny_trainer(algorithm)
        tr2.server = ck.restore_server_flat(path, tr2.server, tr2.layout)
        assert tr2.server.round == 1
        assert_same(tr2.server.complex, tr.server.complex)
        if algorithm == "decouple":
            assert_same(tr2.server.simple_host, tr.server.simple_host)
        assert np.isfinite(tr2.run_round()["loss_complex"])


def test_flat_checkpoint_lossy_wires_within_reference_bounds(tmp_path):
    tr = tiny_trainer()
    tr.run_round()
    sizes = {}
    for dtype in ("float32", "bfloat16", "int8"):
        path = str(tmp_path / f"flat_{dtype}.npz")
        ck.save_server_flat(path, tr.server, tr.layout,
                            wire=comm.WireSpec(dtype, 128))
        sizes[dtype] = os.path.getsize(path)
        tr2 = tiny_trainer()
        tr2.server = ck.restore_server_flat(path, tr2.server, tr2.layout)
        for a, b in zip(tree_leaves(tr2.server.complex),
                        tree_leaves(tr.server.complex)):
            amax = float(b.abs().max()) + 1e-12
            tol = {"float32": 0.0, "bfloat16": amax * 8e-3,
                   "int8": amax / 127.0}[dtype]
            assert float((a - b).abs().max()) <= tol, dtype
    assert sizes["int8"] < sizes["bfloat16"] < sizes["float32"]


def test_flat_checkpoint_layout_mismatch_rejected(tmp_path):
    tr = tiny_trainer()
    path = str(tmp_path / "flat.npz")
    ck.save_server_flat(path, tr.server, tr.layout)
    bigger = flatten.build_layout(tr.server.complex,
                                  total_multiple=2 * tr.layout.n_flat)
    with pytest.raises(ValueError, match="n_flat"):
        ck.restore_server_flat(path, tr.server, bigger)
    collider = flatten.build_layout({"x": torch.zeros(7)},
                                    total_multiple=tr.layout.n_flat)
    assert collider.n_flat == tr.layout.n_flat
    with pytest.raises(ValueError, match="slot table"):
        ck.restore_server_flat(path, tr.server, collider)


def test_sampler_mismatch_and_missing_sidecars_rejected(tmp_path):
    tr = tiny_trainer()
    path = str(tmp_path / "trainer.npz")
    ck.save_trainer(path, tr)
    other = tiny_trainer(seed=1)
    with pytest.raises(ValueError, match="sampler"):
        ck.restore_trainer(path, other)
    with pytest.raises(ValueError, match="__cv_store__"):
        ck.restore_trainer(path, tiny_trainer(variance_reduction="scaffold"))
    with pytest.raises(ValueError, match="__ef_store__"):
        ck.restore_trainer(path, tiny_trainer(comm_dtype="int8",
                                              error_feedback=True))
    with pytest.raises(ValueError, match="unknown checkpoint format"):
        ck.save_trainer(path, tr, fmt="zip")


def test_legacy_server_checkpoint_restores(tmp_path):
    tr = tiny_trainer()
    tr.run_round()
    path = str(tmp_path / "legacy.npz")
    ck.save_server(path, tr.server)
    tr2 = tiny_trainer()
    ck.restore_trainer(path, tr2)
    assert tr2.server.round == 1
    assert tr2.client_state.tracked_clients() == 0   # fresh matrix kept
    assert_same(tr2.server.complex, tr.server.complex)


# -- resume equals an uninterrupted run --------------------------------------

@pytest.mark.parametrize("fmt,extra", [
    ("tree", {}), ("flat", {}), ("tree", dict(async_lag=2)),
    ("flat", dict(variance_reduction="scaffold")),
    ("tree", dict(comm_dtype="int8", topk_frac=0.5,
                  stochastic_rounding=True, error_feedback=True,
                  async_lag=1))],
    ids=["sync-tree", "sync-flat", "async-tree", "scaffold-flat",
         "ef-async-tree"])
def test_resume_equals_uninterrupted(tmp_path, fmt, extra):
    """Two rounds, save, restore into a FRESH trainer, two more rounds:
    the same metrics, server params, stores and client-state matrix as
    four uninterrupted rounds, bitwise (the async versions restart from
    the restored server, as the reference's do)."""
    a = tiny_trainer(**extra)
    hist_a = [a.run_round() for _ in range(4)]
    b = tiny_trainer(**extra)
    for _ in range(2):
        b.run_round()
    path = str(tmp_path / "trainer.ckpt")
    ck.save_trainer(path, b, fmt=fmt)
    c = tiny_trainer(**extra)
    ck.restore_trainer(path, c, fmt=fmt)
    assert c.server.round == 2
    hist_c = [c.run_round() for _ in range(2)]
    if "async_lag" not in extra:
        assert hist_c == hist_a[2:]
        assert_same(c.server.complex, a.server.complex)
    # an async run resumed from round 2 equals one whose versions were
    # reset at round 2 (the restore replaced the server from outside)
    d = tiny_trainer(**extra)
    for _ in range(2):
        d.run_round()
    if d.async_engine is not None:
        d.server = dataclasses.replace(d.server)
    hist_d = [d.run_round() for _ in range(2)]
    assert hist_c == hist_d
    assert_same(c.server.complex, d.server.complex)
    np.testing.assert_array_equal(c.client_state.array, d.client_state.array)
    for store in ("cv_store", "ef_store"):
        if getattr(d, store) is not None:
            ids = np.arange(4)
            assert torch.equal(getattr(c, store).gather(ids),
                               getattr(d, store).gather(ids))
    if c.cv_global is not None:
        assert torch.equal(c.cv_global, d.cv_global)


def test_train_cli_resume_matches_an_uninterrupted_run(tmp_path, capsys):
    """``--async-lag 2 --checkpoint P --checkpoint-every 1`` for 2 rounds,
    then ``--resume`` to round 4: the per-round lines are those of one
    uninterrupted trainer whose server is replaced at round 2 (what the
    restore does; the versions restart from it), except the ``mbytes``
    fields: the byte totals are not part of a checkpoint, in either
    package, and restart from 0."""
    from repro_torch.launch import train
    args = ["--model", "lm", "--arch", "gemma2-2b", "--reduced",
            "--device", "cpu", "--clients", "4", "--participation", "0.5",
            "--data-points", "16", "--seq-len", "16", "--batch-size", "4",
            "--local-epochs", "1", "--eval-every", "1", "--async-lag", "2"]
    path = str(tmp_path / "run.ckpt")
    ckpt = ["--checkpoint", path, "--checkpoint-every", "1"]
    train.main(args + ["--rounds", "2"] + ckpt)
    first = capsys.readouterr().out
    assert "async rounds: lag=2 folds/round=2 versions=2" in first
    assert os.path.exists(path)
    resumed = train.main(args + ["--rounds", "4", "--resume"] + ckpt)
    out = capsys.readouterr().out
    assert "resumed from round 2" in out
    assert [h["round"] for h in resumed] == [3, 4]

    tr, test = train.build_trainer(train.build_parser().parse_args(
        args + ["--rounds", "4"]))
    want = []
    tr.run(2, eval_every=1, test_batch=test, log=want.append)
    tr.server = dataclasses.replace(tr.server)
    tr.run(2, eval_every=1, test_batch=test, log=want.append)
    # the CLI's "[round N] k=v  k=v" (sorted keys) and run()'s
    # "round N: k=v, k=v" (dict order) hold the same values
    fields = lambda ln: (int(re.search(r"round\s+(\d+)", ln).group(1)),
                         {k: v for k, v in re.findall(r"(\w+)=([^\s,]+)", ln)
                          if not k.startswith("mbytes")})
    got = [fields(ln) for ln in (first + out).splitlines()
           if ln.startswith("[round")]
    assert got == [fields(ln) for ln in want]
