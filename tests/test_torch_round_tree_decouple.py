"""Port parity of a decouple round on the tree engine (the rules of
``test_torch_round_tree.py``), and of a fedhen tree round on the bf16
wire under the lossy-wire rules of ``test_torch_round_wire.py``."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_round import ROUND, make_pair, make_shards  # noqa: E402
from test_torch_round_tree import one_tree_round_matches_reference  # noqa
from test_torch_round_wire import run_and_compare  # noqa: E402


def test_one_decouple_tree_round_matches_reference():
    one_tree_round_matches_reference("decouple")


def test_one_fedhen_tree_round_on_the_bf16_wire_matches_reference():
    port, ref = make_pair(make_shards(), algorithm="fedhen",
                          comm_dtype="bfloat16", agg_engine="tree", **ROUND)
    assert port.stream_dtype == torch.bfloat16
    run_and_compare(port, ref, [torch.zeros(port.layout.n_flat)])
