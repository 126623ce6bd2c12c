"""Port parity of whole rounds on the tree engine (``agg_engine="tree"``,
one K4 launch per leaf): one fedhen and one noside round against the
reference's tree round with the reference's own minibatch schedule, and
the port's tree round against its own flat round.  Decouple and the bf16
wire are in ``test_torch_round_tree_decouple.py`` (each file stays under
50 s: a reference round's jit takes 12-30 s to compile on the CPU).

Setup as in ``test_torch_round.py`` with 8 points per client and 2 epochs
(4 SGD steps a client).  Tolerances: server params rtol 1e-4, atol 1e-5;
losses atol 1e-5; ``n_valid`` and bytes exactly.  Tree against flat in
the port: bitwise at ``cohort_chunk=1`` (both add one client's weighted
row to the sum), rtol 1e-5 / atol 1e-6 over a whole population (the tree
sums the chunk first, then adds it).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro_torch.kernels.masked_agg import ops  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_round import (ROUND, assert_round_matches,  # noqa: E402
                              make_pair, make_shards)
from test_torch_round_invariants import _port as _make_port  # noqa: E402
from test_torch_round_schedule import ReferenceSchedule  # noqa: E402

TREE = dict(ROUND, local_epochs=2, agg_engine="tree")


def one_tree_round_matches_reference(algorithm):
    port, ref = make_pair(make_shards(32, 4),
                          port_kw={"schedule": ReferenceSchedule(0, 2)},
                          algorithm=algorithm, **TREE)
    assert port.leaf_masks is not None
    assert_round_matches(port, ref, port.run_round(), ref.run_round())


@pytest.mark.parametrize("algorithm", ["fedhen", "noside"])
def test_one_tree_round_matches_reference(algorithm):
    one_tree_round_matches_reference(algorithm)


def _port(engine, algorithm, chunk):
    return _make_port(make_shards(), agg_engine=engine, algorithm=algorithm,
                      cohort_chunk=chunk)


@pytest.mark.parametrize("algorithm", ["fedhen", "decouple"])
@pytest.mark.parametrize("chunk", [1, 0])
def test_tree_round_matches_the_flat_round(algorithm, chunk):
    flat, tree = _port("flat", algorithm, chunk), _port("tree", algorithm,
                                                        chunk)
    tol = dict(rtol=0, atol=0) if chunk == 1 else dict(rtol=1e-5, atol=1e-6)
    for _ in range(2):
        got, want = tree.run_round(), flat.run_round()
        assert got.keys() == want.keys()
        for key in got:
            np.testing.assert_allclose(got[key], want[key], **tol)
    for models in ((flat.server.complex, tree.server.complex),
                   (flat.server.simple_host, tree.server.simple_host)):
        if models[0] is None:
            assert models[1] is None
            continue
        for a, b in zip(tree_leaves(models[0]), tree_leaves(models[1])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **tol)
    assert flat.total_bytes == tree.total_bytes


def test_tree_round_launches_no_kernel_on_the_cpu():
    counters = (ops.masked_agg_, ops.masked_agg_fold_, ops.masked_agg_acc_)
    before = [fn.launches for fn in counters]
    _port("tree", "fedhen", 0).run_round()
    assert [fn.launches for fn in counters] == before
