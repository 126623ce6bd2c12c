"""Port parity of one decouple round on the bf16 wire (the server model
and the simple host), under the lossy-wire rules of
``test_torch_round_wire.py``."""

import pytest

pytest.importorskip("torch")

from test_torch_round_wire import one_round_on_a_lossy_wire  # noqa: E402


def test_one_decouple_round_on_the_bf16_wire_matches_reference():
    one_round_on_a_lossy_wire("decouple", "bfloat16")
