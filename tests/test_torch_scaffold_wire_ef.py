"""Port parity of two SCAFFOLD fedhen rounds with error feedback on the
int8 wire, under the rules of ``test_torch_scaffold_wire.py``."""

import pytest

pytest.importorskip("torch")

from test_torch_scaffold_wire import (  # noqa: E402
    two_scaffold_fedhen_rounds_on_a_lossy_wire)


def test_two_scaffold_fedhen_rounds_with_error_feedback():
    two_scaffold_fedhen_rounds_on_a_lossy_wire(
        dict(comm_dtype="int8", error_feedback=True))
