"""Port parity of one noside round on the bf16 and int8 wires, under the
lossy-wire rules of ``test_torch_round_wire.py``."""

import pytest

pytest.importorskip("torch")

from test_torch_round_wire import one_round_on_a_lossy_wire  # noqa: E402


@pytest.mark.parametrize("wire", ["bfloat16", "int8"])
def test_one_noside_round_on_a_lossy_wire_matches_reference(wire):
    one_round_on_a_lossy_wire("noside", wire)
