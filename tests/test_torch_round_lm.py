"""Port parity of one synchronous LM round: fedhen, noside and decouple
on ``attn4`` (the attention-only config of every committed BENCH row;
``torch_lm_cases``) on the flat engine, fedhen on the tree engine and
fedhen on reduced recurrentgemma-2b; and the LM training command line on
the CPU.

4 clients (2 simple + 2 complex), participation 1.0, ``cohort_chunk=1``,
8 ``synthetic_lm`` sequences of 16 tokens a client, batch 4: two SGD
steps a client, in the order the reference's own keys give
(``ReferenceSchedule``).  Both trainers start from the same weights: the
port draws them, the reference receives them through a test-local
adapter.  Tolerances: server params rtol 1e-4, atol 1e-5; losses and
eval metrics atol 1e-5; ``n_valid`` and bytes per round exactly.  A bf16
model's tree round keeps bf16 params and equals its flat round bitwise
(port against port, ``cohort_chunk=1``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro.configs.base import FedConfig as RefFedConfig  # noqa: E402
from repro.core.adapters import LMAdapter as RefLMAdapter  # noqa: E402
from repro.core.federated import FederatedTrainer as RefTrainer  # noqa

from test_torch_round import assert_round_matches  # noqa: E402
from test_torch_round_schedule import ReferenceSchedule  # noqa: E402
from torch_lm_cases import config_pair  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.core.adapters import LMAdapter  # noqa: E402
from repro_torch.core.federated import FederatedTrainer  # noqa: E402
from repro_torch.data.federated import iid_split  # noqa: E402
from repro_torch.data.synthetic import synthetic_lm  # noqa: E402
from repro_torch.kernels.masked_agg import ops  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

SEQ = 16
ROUND = dict(n_devices=4, n_simple=2, participation=1.0, local_epochs=1,
             batch_size=4, cohort_chunk=1)


def lm_shards(vocab, n_clients=4, per_client=8):
    data = synthetic_lm(n_clients * per_client, SEQ, vocab, seed=0)
    return [{"tokens": s["tokens"]}
            for s in iid_split(data, n_clients, seed=1)]


def make_lm_pair(case, **kw):
    """(port trainer, reference trainer, test batch) of ``case``, from
    the same initial weights and minibatch order."""
    ref_cfg, cfg = config_pair(case)
    shards = lm_shards(cfg.vocab_size)
    port = FederatedTrainer(LMAdapter(cfg), FedConfig(**kw), shards,
                            device="cpu",
                            generator=torch.Generator().manual_seed(0),
                            schedule=ReferenceSchedule(0, kw["local_epochs"]))
    start = interop.to_reference(port.server.complex)

    class SameStart(RefLMAdapter):
        def init(self, key):
            return jax.tree.map(jnp.asarray, start)

    ref = RefTrainer(SameStart(ref_cfg), RefFedConfig(**kw),
                     [{k: jnp.asarray(v) for k, v in s.items()}
                      for s in shards])
    test = {"tokens": synthetic_lm(8, SEQ, cfg.vocab_size, seed=999)[
        "tokens"]}
    return port, ref, test


def assert_lm_round_matches(port, ref, test):
    assert_round_matches(port, ref, port.run_round(), ref.run_round())
    got = port.evaluate(test)
    want = ref.evaluate({"tokens": jnp.asarray(test["tokens"])})
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5,
                                   err_msg=key)


@pytest.mark.parametrize("algorithm", ["fedhen", "noside", "decouple"])
def test_one_lm_round_matches_reference(algorithm):
    port, ref, test = make_lm_pair("attn4", algorithm=algorithm, **ROUND)
    assert port.flat_mask.sum() < port.layout.n_params   # M cuts leaves
    assert_lm_round_matches(port, ref, test)


def test_one_lm_tree_round_matches_reference():
    ops.masked_agg_fold_.launches = 0
    port, ref, test = make_lm_pair("attn4", algorithm="fedhen",
                                   agg_engine="tree", **ROUND)
    assert port.leaf_masks is not None
    assert_lm_round_matches(port, ref, test)
    assert ops.masked_agg_fold_.launches == 0


def test_bf16_tree_round_keeps_param_dtypes_and_equals_flat():
    _, cfg = config_pair("gemma2-2b-deep")
    cfg = cfg.with_overrides(param_dtype="bfloat16",
                             compute_dtype="bfloat16")
    shards = lm_shards(cfg.vocab_size)
    servers = []
    for engine in ("flat", "tree"):
        t = FederatedTrainer(LMAdapter(cfg),
                             FedConfig(algorithm="fedhen", agg_engine=engine,
                                       **ROUND), shards, device="cpu")
        before = [x.dtype for x in tree_leaves(t.server.complex)]
        t.run_round()
        assert [x.dtype for x in tree_leaves(t.server.complex)] == before
        servers.append(tree_leaves(t.server.complex))
    assert all(torch.equal(a, b) for a, b in zip(*servers))


def test_one_recurrentgemma_round_matches_reference():
    port, ref, test = make_lm_pair("recurrentgemma-2b", algorithm="fedhen",
                                   **ROUND)
    assert_lm_round_matches(port, ref, test)


def test_train_cli_runs_an_lm_round_on_the_cpu(capsys, monkeypatch):
    from repro_torch.launch import train
    args = ["--model", "lm", "--arch", "gemma2-2b", "--reduced",
            "--device", "cpu", "--rounds", "1", "--clients", "4",
            "--participation", "0.5", "--data-points", "16",
            "--seq-len", "16", "--batch-size", "4", "--local-epochs", "1",
            "--eval-every", "1"]
    history = train.main(args)
    assert len(history) == 1 and history[0]["round"] == 1
    for key in ("loss_simple", "loss_complex", "acc_simple",
                "acc_complex"):
        assert key in history[0]
    out = capsys.readouterr().out
    assert "[round    1]" in out and "fedhen: 1 rounds in" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main([a for a in args if a not in ("--device", "cpu")])
