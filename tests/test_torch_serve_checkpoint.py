"""Serving from a checkpoint: a model the port trained, saved as a bare
params tree (``save_tree``), serves the same greedy tokens and exit
statistics through the reference's ``generate`` (restored by the
reference's ``restore_tree``) and the port's (restored by
``serve.load_params``, the ``--checkpoint`` path); and ``serve.main
--checkpoint`` restores a bare tree and refuses a trainer checkpoint with
the reference's ``KeyError``.

The model: reduced gemma2-2b (exit at its last layer) and the same
deepened to 5 layers with the exit after layer 2, trained by the port's
``FederatedTrainer`` (fedhen, 8 clients at participation 0.5,
``synthetic_lm``, lr 0.5) for 16 and 12 rounds.  Tokens exactly and the
statistics equal, as in ``test_torch_serve.py``.  The statistics are
printed (``-s``).  At random weights both heads agree on every token and
neither is confident; trained, the deepened model's heads disagree on
some tokens, while the reduced config, whose exit is its last layer,
keeps agreement 1.0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro.checkpoint import checkpoint as ref_ck  # noqa: E402
from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import transformer as ref_tfm  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import checkpoint as ck  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.core.adapters import LMAdapter  # noqa: E402
from repro_torch.core.federated import FederatedTrainer  # noqa: E402
from repro_torch.data.federated import iid_split  # noqa: E402
from repro_torch.data.synthetic import synthetic_lm  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

S, STEPS = 40, 8
THRESHOLD = 0.3


def trained(cfg, rounds: int) -> FederatedTrainer:
    data = synthetic_lm(8 * 16, 32, cfg.vocab_size, seed=0)
    shards = [{"tokens": s["tokens"]} for s in iid_split(data, 8, seed=1)]
    fed = FedConfig(n_devices=8, n_simple=4, participation=0.5,
                    local_epochs=1, batch_size=8, lr=0.5, algorithm="fedhen",
                    seed=0)
    tr = FederatedTrainer(LMAdapter(cfg), fed, shards, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    tr.run(rounds)
    return tr


@pytest.mark.parametrize("overrides,rounds", [
    ({}, 16), (dict(n_layers=5, exit_layer=2), 12)],
    ids=["reduced", "deep"])
def test_trained_checkpoint_serves_alike_in_both_packages(tmp_path,
                                                          overrides, rounds):
    cfg = configs.get_reduced("gemma2-2b").with_overrides(**overrides)
    ref_cfg = ref_reduced("gemma2-2b").with_overrides(**overrides)
    path = str(tmp_path / "params.npz")
    ck.save_tree(path, trained(cfg, rounds).server.complex)
    params = serve.load_params(cfg, 3, "cpu", path)
    ref_params, _ = ref_ck.restore_tree(
        path, ref_tfm.init_params(jax.random.PRNGKey(3), ref_cfg))
    prompts = synthetic_lm(2, S, cfg.vocab_size, seed=5)["tokens"][:, :S]
    stats = {}
    for threshold in (0.0, THRESHOLD):
        want_tok, want = ref_serve.generate(
            ref_params, ref_cfg, jnp.asarray(prompts), STEPS,
            adaptive_threshold=threshold)
        got_tok, got = serve.generate(
            params, cfg, torch.from_numpy(prompts).long(), STEPS,
            adaptive_threshold=threshold)
        np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
        assert got == want
        stats[threshold] = got
    print(f"gemma2-2b reduced {overrides} after {rounds} rounds: {stats}")
    if overrides:
        # an exit before the last layer: trained, the statistics are not
        # the random-weight ones (the reduced config exits at its last
        # layer, where the tied heads agree on every token)
        assert stats[0.0]["exit_agreement"] < 1.0


def test_serve_main_restores_a_bare_tree_and_refuses_a_trainer_checkpoint(
        tmp_path):
    cfg = configs.get_reduced("gemma2-2b")
    args = ["--arch", "gemma2-2b", "--batch", "2", "--prompt-len", "8",
            "--gen", "3", "--device", "cpu"]
    bare = str(tmp_path / "params.npz")
    ck.save_tree(bare, serve.load_params(cfg, 7, "cpu"))
    stats = serve.main(args + ["--checkpoint", bare])
    assert set(stats) == {"exit_agreement", "exit_confident_frac"}
    # seed 0's fresh draw is replaced by seed 7's saved params
    restored = serve.load_params(cfg, 0, "cpu", bare)
    fresh = serve.load_params(cfg, 7, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree.leaves(restored), jax.tree.leaves(fresh)))
    trainer = str(tmp_path / "trainer.npz")
    ck.save_trainer(trainer, trained(cfg, 0))
    with pytest.raises(KeyError, match="checkpoint missing leaf"):
        serve.main(args + ["--checkpoint", trainer])
