"""Port parity of uniform cohort sampling (``sample_uniform=True``, the
paper's protocol): one draw of ``ceil(p * n_devices)`` clients split by
architecture into slot blocks, unfilled slots wrapping drawn ids at
weight 0.

Two rounds against the reference's: round 0 realises no simple client
(both simple slots are pads), round 1 one simple and one complex client.
Setup as in ``test_torch_round.py`` (narrow PreActResNet18-GN, 16x16
synthetic CIFAR), 8 clients, 4 points each, one SGD step a round, so the
minibatch order cannot matter.  Tolerances: server params rtol 1e-4, atol
1e-5; losses atol 1e-5 (each divided by its population's real count);
``n_valid`` and the realised clients' bytes exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_round import (ROUND, assert_round_matches,  # noqa: E402
                              make_pair, make_shards)
from test_torch_round_invariants import _port  # noqa: E402

UNIFORM = dict(ROUND, n_devices=8, n_simple=4, participation=0.25,
               sample_uniform=True)


def test_two_uniform_rounds_match_reference():
    port, ref = make_pair(make_shards(32, 8), **UNIFORM)
    assert (port.k_simple, port.k_complex) == (2, 2)
    for r in range(2):
        plan = port.sampler.plan(r)
        before = port.total_bytes
        got, want = port.run_round(), ref.run_round()
        assert_round_matches(port, ref, got, want)
        # pad slots fold at weight 0 and count nowhere
        assert got["n_valid"] == plan.n_real_simple + plan.n_real_complex
        if plan.n_real_simple == 0:
            assert got["loss_simple"] == 0.0
        # only the realised clients are billed, down and up
        billed = 2 * (plan.n_real_simple * port.per_simple_bytes
                      + plan.n_real_complex * port.per_complex_bytes)
        assert port.total_bytes - before == billed
        assert port.total_bytes == ref.total_bytes
        assert (port.total_bytes_down, port.total_bytes_up) == \
            (ref.total_bytes_down, ref.total_bytes_up)
    assert not port.sampler.plan(0).all_real
    np.testing.assert_array_equal(port.client_state.column("participation"),
                                  ref.client_state.column("participation"))


def test_pad_slot_loss_and_validity_are_those_of_the_real_clients():
    shards = make_shards(32, 8)
    shards[7] = dict(shards[7])
    shards[7]["images"] = np.full_like(shards[7]["images"], np.nan)
    t = _port(shards, **UNIFORM)
    plan = t.sampler.plan(1)       # simple [3, pad], complex [7 (NaN), pad]
    assert list(plan.complex_ids) == [7, 7]
    t.run_round()
    m = t.run_round()
    assert m["n_valid"] == 1.0     # client 3; client 7 is NaN, pads are 0
    assert np.isfinite(m["loss_simple"])
    assert all(bool(torch.isfinite(x).all())
               for x in tree_leaves(t.server.complex))
