"""FedProx's proximal term in the port, the counterparts of
``tests/test_fedprox.py`` (drift shrinks as mu grows; the term composes
with a fedhen round), and one client's local training with the term held
to the reference's ``make_client_trainer``.

The reference's two-layer attention config, in f32.  Parity: the same
weights (drawn by the reference, carried with ``interop``), the same
tokens and the reference's minibatch order; three SGD steps, since the
term and its gradient are 0 at the first one (the client starts at the
anchor); rtol 1e-4 / atol 1e-5, the port's f32 tolerance against the
reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro.configs.base import FedConfig as RefFedConfig  # noqa: E402
from repro.configs.base import LayerSpec as RefLayerSpec  # noqa: E402
from repro.configs.base import ModelConfig as RefModelConfig  # noqa: E402
from repro.core.adapters import LMAdapter as RefLMAdapter  # noqa: E402
from repro.core.federated import \
    make_client_trainer as ref_make_client_trainer  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.core.adapters import LMAdapter  # noqa: E402
from repro_torch.core.federated import (FederatedTrainer,  # noqa: E402
                                        make_client_trainer)
from repro_torch.data.federated import iid_split  # noqa: E402
from repro_torch.data.synthetic import synthetic_lm  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from torch_lm_cases import _port_copy  # noqa: E402

REF_CFG = RefModelConfig(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                         d_ff=64, vocab_size=64,
                         pattern=(RefLayerSpec("attn"),), exit_layer=1,
                         compute_dtype="float32")
CFG = _port_copy(REF_CFG)
TOL = dict(rtol=1e-4, atol=1e-5)


def _drift(mu):
    fed = FedConfig(n_devices=2, n_simple=1, participation=1.0,
                    local_epochs=3, batch_size=4, lr=0.2, prox_mu=mu)
    adapter = LMAdapter(CFG)
    params = adapter.init(torch.Generator().manual_seed(0), "cpu")
    data = {"tokens": torch.from_numpy(
        synthetic_lm(16, 16, 64, seed=1)["tokens"])}
    g = torch.Generator().manual_seed(2)
    perms = [torch.randperm(16, generator=g) for _ in range(3)]
    train = make_client_trainer(adapter.loss_complex, fed)
    new, _ = train(params, data, perms)
    return float(sum(torch.sum(torch.square(a - b)) for a, b in
                     zip(tree_leaves(new), tree_leaves(params))))


def test_prox_term_limits_client_drift():
    d0 = _drift(0.0)
    d_strong = _drift(10.0)
    assert d_strong < d0, (d_strong, d0)


def test_prox_composes_with_fedhen():
    fed = FedConfig(n_devices=4, n_simple=2, participation=0.5, rounds=2,
                    local_epochs=1, batch_size=4, algorithm="fedhen",
                    prox_mu=0.1)
    data = synthetic_lm(32, 16, 64, seed=1)
    shards = [{"tokens": s["tokens"]} for s in iid_split(data, 4, seed=2)]
    tr = FederatedTrainer(LMAdapter(CFG), fed, shards, device="cpu")
    m = tr.run_round()
    assert np.isfinite(m["loss_complex"]) and np.isfinite(m["loss_simple"])


@pytest.mark.parametrize("loss", ["loss_complex", "loss_side"])
def test_prox_client_training_matches_reference(loss):
    kw = dict(n_devices=2, n_simple=1, participation=1.0, local_epochs=1,
              batch_size=4, lr=0.2, prox_mu=5.0)
    ref_p = RefLMAdapter(REF_CFG).init(jax.random.PRNGKey(0))
    params = interop.from_reference(jax.tree.map(np.asarray, ref_p))
    tok = synthetic_lm(12, 16, 64, seed=1)["tokens"]
    rng = jax.random.PRNGKey(3)
    want, want_loss = jax.jit(ref_make_client_trainer(
        getattr(RefLMAdapter(REF_CFG), loss), RefFedConfig(**kw)))(
        ref_p, {"tokens": jnp.asarray(tok)}, rng)
    # the reference's minibatch order: one permutation per epoch key
    perms = [np.array(jax.random.permutation(key, len(tok)))
             for key in jax.random.split(rng, kw["local_epochs"])]
    port = make_client_trainer(getattr(LMAdapter(CFG), loss),
                               FedConfig(**kw))
    got, got_loss = port(params, {"tokens": torch.from_numpy(tok)}, perms)
    plain, _ = make_client_trainer(getattr(LMAdapter(CFG), loss),
                                   FedConfig(**dict(kw, prox_mu=0.0)))(
        params, {"tokens": torch.from_numpy(tok)}, perms)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), **TOL)
    moved = 0.0
    for g, w, p in zip(tree_leaves(got), jax.tree.leaves(want),
                       tree_leaves(plain)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        moved = max(moved, float((g - p).abs().max()))
    assert moved > 1e-4       # the term steered the client
