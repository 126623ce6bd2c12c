"""Port parity of a decouple round, and of two fedhen rounds whose
minibatch order is fed from the reference's own key path.

The reference draws each client's epoch permutation from threefry keys:
round key ``PRNGKey(seed * 100003 + round)``, split into the simple and
complex population keys, ``fold_in`` of the client's slot, one split per
epoch, ``jax.random.permutation``.  The port takes its schedule from a
provider, so this test fills the provider with exactly those
permutations.  Setup and tolerances as in ``test_torch_round.py``.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from test_torch_round import (ROUND, assert_round_matches,  # noqa: E402
                              make_pair, make_shards)


class ReferenceSchedule:
    """The reference trainer's minibatch permutations, recomputed."""

    def __init__(self, seed: int, epochs: int):
        self.seed, self.epochs = seed, epochs

    def __call__(self, round_index, population, slot, epoch, n):
        key = jax.random.PRNGKey(self.seed * 100003 + round_index)
        rs, rc = jax.random.split(key)
        client = jax.random.fold_in(rs if population == "simple" else rc,
                                    slot)
        return np.array(jax.random.permutation(
            jax.random.split(client, self.epochs)[epoch], n))


def test_decouple_round_matches_reference():
    port, ref = make_pair(make_shards(), algorithm="decouple", **ROUND)
    assert_round_matches(port, ref, port.run_round(), ref.run_round())


def test_two_fedhen_rounds_with_reference_schedule():
    # 8 points per client, batch 4: 2 SGD steps per epoch, 2 epochs
    kw = dict(ROUND, batch_size=4, local_epochs=2, algorithm="fedhen")
    port, ref = make_pair(
        make_shards(32, 4),
        port_kw={"schedule": ReferenceSchedule(seed=0, epochs=2)}, **kw)
    for _ in range(2):
        assert_round_matches(port, ref, port.run_round(), ref.run_round())
    assert port.server.round == ref.server.round == 2
