"""Port parity of two fedhen rounds on the compressed wire (int8, top-k
1/14, stochastic rounding, error feedback) with the reference's minibatch
schedule and random bits: server params, EF rows and the client-state
matrix, under the lossy-wire rules of ``test_torch_round_wire.py``."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_round import ROUND, make_pair, make_shards  # noqa: E402
from test_torch_round_schedule import ReferenceSchedule  # noqa: E402
from test_torch_round_wire import ReferenceBits, run_and_compare  # noqa

COMPRESSED = dict(comm_dtype="int8", topk_frac=1 / 14,
                  stochastic_rounding=True, error_feedback=True)


def test_two_compressed_fedhen_rounds_with_reference_schedule_and_bits():
    # 4 points per client, batch 4: 1 SGD step per epoch, 2 epochs
    kw = dict(ROUND, local_epochs=2, algorithm="fedhen", **COMPRESSED)
    port, ref = make_pair(
        make_shards(16, 4), port_kw={"schedule": ReferenceSchedule(0, 2),
                                     "bits": ReferenceBits(0)}, **kw)
    assert (port.k_top_simple, port.k_top_complex) == (896, 2176)
    assert port.ef_store.backend == ref.ef_store.backend == "device"
    carry = [torch.zeros(port.layout.n_flat)]
    for _ in range(2):
        carry = run_and_compare(port, ref, carry)
    assert port.server.round == ref.server.round == 2
