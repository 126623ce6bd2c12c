"""Port parity of two SCAFFOLD fedhen rounds on the compressed wire
(int8, top-k 1/14, stochastic rounding, error feedback), under the rules
of ``test_torch_scaffold_wire.py``, with the reference's own spread at a
ReLU kink (``ReferenceSpread``)."""

import pytest

pytest.importorskip("torch")

from test_torch_round_wire_v2 import COMPRESSED  # noqa: E402
from test_torch_scaffold_wire import (  # noqa: E402
    two_scaffold_fedhen_rounds_on_a_lossy_wire)


def test_two_scaffold_fedhen_rounds_on_the_compressed_wire():
    two_scaffold_fedhen_rounds_on_a_lossy_wire(COMPRESSED, spread=True)
