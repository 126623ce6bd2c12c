"""Port parity of one synchronous federated round (fedhen, noside).

A narrow PreActResNet18-GN (every width is read from the params) on 16x16
synthetic CIFAR, 4 clients (2 simple + 2 complex), participation 1.0,
``cohort_chunk=1``.  Both trainers start from the same weights: the port
draws them, the reference receives them through a test-local adapter.
With one SGD step over the whole local dataset the minibatch order cannot
matter, so no schedule needs to be shared.  Tolerances: server params
rtol 1e-4, atol 1e-5 (training differences compound through the model);
losses atol 1e-5; ``n_valid`` and bytes per round exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro.configs.base import FedConfig as RefFedConfig  # noqa: E402
from repro.core.adapters import ResNetAdapter as RefAdapter  # noqa: E402
from repro.core.federated import FederatedTrainer as RefTrainer  # noqa

from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.core.adapters import ResNetAdapter  # noqa: E402
from repro_torch.core.federated import FederatedTrainer  # noqa: E402
from repro_torch.data.federated import iid_split  # noqa: E402
from repro_torch.data.synthetic import synthetic_cifar  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

NARROW = (8, 16, 16, 16)
SIZE = 16


def make_shards(n_points=16, n_clients=4):
    return iid_split(synthetic_cifar(n_points, 10, seed=0, image_size=SIZE),
                     n_clients, seed=1)


def make_pair(shards, *, port_kw=None, **kw):
    """(port trainer, reference trainer) from the same initial weights."""
    port = FederatedTrainer(ResNetAdapter(10, NARROW), FedConfig(**kw),
                            shards, device="cpu",
                            generator=torch.Generator().manual_seed(0),
                            **(port_kw or {}))
    start = interop.to_reference(port.server.complex)

    class SameStart(RefAdapter):
        def init(self, key):
            return jax.tree.map(jnp.asarray, start)

    ref = RefTrainer(SameStart(10), RefFedConfig(**kw),
                     [{k: jnp.asarray(v) for k, v in s.items()}
                      for s in shards])
    return port, ref


def assert_round_matches(port, ref, port_metrics, ref_metrics):
    for key in ("loss_simple", "loss_complex"):
        np.testing.assert_allclose(port_metrics[key], ref_metrics[key],
                                   rtol=0, atol=1e-5)
    assert port_metrics["n_valid"] == ref_metrics["n_valid"]
    assert port.bytes_per_round == ref.bytes_per_round
    assert port.analytic_bytes_per_round() == ref.analytic_bytes_per_round()
    models = [(port.server.complex, ref.server.complex)]
    if ref.server.simple_host is not None:
        models.append((port.server.simple_host, ref.server.simple_host))
    for mine, theirs in models:
        for a, b in zip(tree_leaves(mine), jax.tree.leaves(theirs)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=1e-5)


ROUND = dict(n_devices=4, n_simple=2, participation=1.0, local_epochs=1,
             batch_size=4, cohort_chunk=1)


@pytest.mark.parametrize("algorithm", ["fedhen", "noside"])
def test_one_round_matches_reference(algorithm):
    port, ref = make_pair(make_shards(), algorithm=algorithm, **ROUND)
    assert_round_matches(port, ref, port.run_round(), ref.run_round())
    assert port.evaluate(make_shards(32, 1)[0])["mbytes"] == \
        ref.evaluate({k: jnp.asarray(v) for k, v in
                      make_shards(32, 1)[0].items()})["mbytes"]
