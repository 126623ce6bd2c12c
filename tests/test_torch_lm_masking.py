"""Port parity of the decoder's index set M and of ``synthetic_lm``.

``transformer_subnet_mask``, ``mask_size``, ``apply_mask``,
``extract_simple`` and ``embed_simple`` against ``repro.core.masking``
on the same weights (``torch_lm_cases``), where a period-stacked leaf's
mask is the first partial-leaf mask the flat layout meets: its
``flatten.pack_mask`` bitvector must equal the reference's.  Masks,
sizes, bitvectors, copies and ``synthetic_lm``'s arrays are exact.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro.core import flatten as ref_flatten  # noqa: E402
from repro.core import masking as ref_masking  # noqa: E402
from repro.data import synthetic as ref_synthetic  # noqa: E402

from torch_lm_cases import CASES, config_pair, params_pair  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.core import flatten, masking  # noqa: E402
from repro_torch.core.adapters import LMAdapter  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


def _leaf_masks(mask, params):
    """Every mask leaf expanded to its parameter's shape, as numpy."""
    return [np.broadcast_to(np.asarray(m.numpy() if isinstance(
        m, torch.Tensor) else m), tuple(x.shape))
        for m, x in zip(tree_leaves(mask), tree_leaves(params))]


@pytest.mark.parametrize("case", list(CASES))
def test_subnet_mask_and_size_match_reference(case):
    ref_cfg, cfg = config_pair(case)
    ref_p, p = params_pair(ref_cfg)
    want = ref_masking.transformer_subnet_mask(ref_p, ref_cfg)
    got = LMAdapter(cfg).subnet_mask(p)
    ref_leaves = [np.broadcast_to(np.asarray(m), x.shape) for m, x in
                  zip(jax.tree.leaves(want), jax.tree.leaves(ref_p))]
    assert len(ref_leaves) == len(tree_leaves(got))
    for a, b in zip(_leaf_masks(got, p), ref_leaves):
        np.testing.assert_array_equal(a, b)
    # stacked leaves carry (n_periods, 1, ...) tensors, the rest bools
    for m, x in zip(tree_leaves(got["periods"]), tree_leaves(p["periods"])):
        assert m.shape == (x.shape[0],) + (1,) * (x.dim() - 1)
    assert masking.mask_size(got, p) == ref_masking.mask_size(want, ref_p)


@pytest.mark.parametrize("case", ["gemma2-2b-deep",
                                  "recurrentgemma-2b-deep", "attn4"])
def test_pack_mask_bitvector_matches_reference(case):
    ref_cfg, cfg = config_pair(case)
    ref_p, p = params_pair(ref_cfg)
    ref_layout = ref_flatten.build_layout(ref_p, total_multiple=2048)
    want = ref_flatten.pack_mask(
        ref_layout, ref_masking.transformer_subnet_mask(ref_p, ref_cfg))
    layout = flatten.build_layout(p, total_multiple=2048)
    assert layout.signature == ref_layout.signature
    got = flatten.pack_mask(layout, masking.transformer_subnet_mask(p, cfg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a partial leaf: some but not all of a stacked leaf's slot is in M
    first = tree_leaves(p["periods"])[0]
    slot = layout.slots[[x is first for x in tree_leaves(p)].index(True)]
    part = got[slot.offset:slot.offset + slot.size]
    assert 0 < int(part.sum()) < slot.size


@pytest.mark.parametrize("case", ["gemma2-2b-deep",
                                  "recurrentgemma-2b-deep"])
def test_apply_extract_and_embed_simple_match_reference(case):
    ref_cfg, cfg = config_pair(case)
    ref_p, p = params_pair(ref_cfg)
    ref_mask = ref_masking.transformer_subnet_mask(ref_p, ref_cfg)
    mask = masking.transformer_subnet_mask(p, cfg)
    for a, b in zip(tree_leaves(masking.apply_mask(mask, p)),
                    jax.tree.leaves(ref_masking.apply_mask(ref_mask,
                                                           ref_p))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want = ref_masking.extract_simple(ref_p, ref_cfg)
    got = masking.extract_simple(p, cfg)
    assert sorted(got) == sorted(want)
    assert jax.tree.structure(interop.to_reference(got)) == \
        jax.tree.structure(jax.tree.map(np.asarray, want))
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # write a changed simple tree back: [w_c]_M := w_s
    ref_s = jax.tree.map(lambda x: x + 1.0, want)
    s = interop.from_reference(jax.tree.map(np.asarray, ref_s))
    embedded = masking.embed_simple(s, p, cfg)
    ref_embedded = ref_masking.embed_simple(ref_s, ref_p, ref_cfg)
    assert jax.tree.structure(interop.to_reference(embedded)) == \
        jax.tree.structure(jax.tree.map(np.asarray, ref_embedded))
    for a, b in zip(tree_leaves(embedded), jax.tree.leaves(ref_embedded)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # and the complex tree given in is left as it was
    for a, b in zip(tree_leaves(p), jax.tree.leaves(ref_p)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("n,s,vocab,seed,codebooks", [
    (6, 12, 64, 0, 1), (3, 33, 512, 7, 1), (4, 9, 100, 2, 3)])
def test_synthetic_lm_arrays_equal(n, s, vocab, seed, codebooks):
    want = ref_synthetic.synthetic_lm(n, s, vocab, seed=seed,
                                      n_codebooks=codebooks)
    got = synthetic.synthetic_lm(n, s, vocab, seed=seed,
                                 n_codebooks=codebooks)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


def test_forward_simple_on_an_extracted_tree_equals_the_complex_prefix():
    ref_cfg, cfg = config_pair("gemma2-2b-deep")
    _, p = params_pair(ref_cfg)
    tok = torch.arange(24, dtype=torch.int32).reshape(2, 12) % cfg.vocab_size
    a = tfm.forward_simple(p, cfg, tok)
    b = tfm.forward_simple(masking.extract_simple(p, cfg), cfg, tok)
    assert torch.equal(a, b)
