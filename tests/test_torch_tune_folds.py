"""``repro_torch.launch.tune_folds`` on the CPU: each variant is one edit
of K1's and K2's sources, and every edit still finds its text there (a
stale edit would make the tool raise on the card, after its build)."""

import pytest

pytest.importorskip("torch")

from repro_torch.launch import tune_folds  # noqa: E402


@pytest.mark.parametrize("name,edits", tune_folds.VARIANTS,
                         ids=[v[0] for v in tune_folds.VARIANTS])
def test_variant_edits_apply(tmp_path, name, edits):
    src = tune_folds.variant_source(tmp_path, edits)
    for f in tune_folds.FILES:
        text = (src / f).read_text()
        original = (tune_folds.CSRC / f).read_text()
        if f in edits:
            old, new = edits[f]
            assert new in text and text != original
        else:
            assert text == original
