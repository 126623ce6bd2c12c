"""Port parity of SCAFFOLD (option II) rounds against the reference's:
two fedhen rounds on the flat engine with the reference's minibatch
schedule — the second round trains with c != 0 — holding the server
params, the server control variate ``cv_global``, every store row and the
client-state matrix's ``cv_scale`` column.  The tree engine's rounds are
in ``test_torch_scaffold_rounds_tree.py``.

Setup as in ``test_torch_round_tree.py`` (8 points per client, 2 epochs:
K = 4 SGD steps, so dc = (x - y) / 0.4 - c).  Tolerances: server params,
``cv_global`` and the rows rtol 1e-4, atol 1e-5; losses atol 1e-5;
``n_valid`` and bytes exactly.  The reference's tol=0 option-II oracle
(``tests/test_scaffold.py``) fails on this tree and is not adopted: the
port is held to the reference's round output.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro_torch import interop  # noqa: E402
from repro_torch.core import flatten  # noqa: E402
from test_torch_round import (ROUND, assert_round_matches,  # noqa: E402
                              make_pair, make_shards)
from test_torch_round_schedule import ReferenceSchedule  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)


def assert_scaffold_state_matches(port, ref):
    np.testing.assert_allclose(port.cv_global.numpy(),
                               np.asarray(ref.cv_global), **TOL)
    ids = np.arange(port.fed.n_devices)
    np.testing.assert_allclose(port.cv_store.gather(ids).numpy(),
                               ref.cv_store.to_array(), **TOL)
    np.testing.assert_allclose(port.client_state.column("cv_scale"),
                               ref.client_state.column("cv_scale"),
                               rtol=1e-5)
    assert port.cv_store.scattered_bytes == ref.cv_store.scattered_bytes


def two_scaffold_rounds_match_reference(algorithm, engine):
    kw = dict(ROUND, local_epochs=2, algorithm=algorithm, agg_engine=engine,
              variance_reduction="scaffold")
    port, ref = make_pair(make_shards(32, 4),
                          port_kw={"schedule": ReferenceSchedule(0, 2)},
                          **kw)
    assert port.cv_store.backend == ref.cv_store.backend == "device"
    for r in range(2):
        assert_round_matches(port, ref, port.run_round(), ref.run_round())
        assert_scaffold_state_matches(port, ref)
        if r == 0:
            assert float(port.cv_global.abs().max()) > 0.0
    assert port.total_bytes == ref.total_bytes
    # the server model moved as the reference's did: a cross-check of the
    # flat unpack of the tree-shaped server params
    flat = flatten.pack(port.layout, interop.from_reference(
        jax.tree.map(np.asarray, ref.server.complex)))
    np.testing.assert_allclose(
        flatten.pack(port.layout, port.server.complex).numpy(),
        flat.numpy(), **TOL)


def test_two_fedhen_scaffold_rounds_match_reference():
    two_scaffold_rounds_match_reference("fedhen", "flat")
