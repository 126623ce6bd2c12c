"""Port parity of one decouple round on the int8 wire (the server model
and the simple host), under the lossy-wire rules of
``test_torch_round_wire.py``; the bf16 wire's round is in
``test_torch_round_wire_decouple_bf16.py`` (a decouple round's reference
jit alone takes 15-30 s to compile on the CPU)."""

import pytest

pytest.importorskip("torch")

from test_torch_round_wire import one_round_on_a_lossy_wire  # noqa: E402


def test_one_decouple_round_on_the_int8_wire_matches_reference():
    one_round_on_a_lossy_wire("decouple", "int8")
