"""Port parity of two SCAFFOLD decouple rounds on the tree engine against
the reference's, under the rules of ``test_torch_scaffold_rounds.py``
(the cv fold is the flat K1 launch on both engines)."""

import pytest

pytest.importorskip("torch")

from test_torch_scaffold_rounds import (  # noqa: E402
    two_scaffold_rounds_match_reference)


def test_two_decouple_scaffold_rounds_on_the_tree_engine_match_reference():
    two_scaffold_rounds_match_reference("decouple", "tree")
