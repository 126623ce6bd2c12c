"""Port parity of the flat layout, pack/unpack/pack_mask and interop.

Both packages must build the same layout for the same tree (so a flat
vector of one unpacks in the other) — at full width (11,175,936 flat
elements for PreActResNet18-GN at agg_block_n 2048) and narrow.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro.core import flatten as ref_flatten  # noqa: E402
from repro.core import masking as ref_masking  # noqa: E402
from repro.models import resnet as ref_resnet  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.core import flatten, masking  # noqa: E402
from repro_torch.models import resnet  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

NARROW = (8, 16, 16, 16)


def _narrow_tree(seed=0):
    p = resnet.init_params(torch.Generator().manual_seed(seed), 10, NARROW)
    return p, interop.to_reference(p)


def _assert_same_layout(mine, ref):
    assert mine.n_flat == ref.n_flat
    assert mine.n_params == ref.n_params
    assert mine.n_leaves == ref.n_leaves
    for a, b in zip(mine.slots, ref.slots):
        assert (a.offset, a.size, a.padded, a.shape) == \
            (b.offset, b.size, b.padded, b.shape)
    assert mine.signature == ref.signature


def test_full_width_layout_matches_reference():
    ref_shapes = jax.eval_shape(
        lambda: ref_resnet.init_params(jax.random.PRNGKey(0)))
    mine = flatten.build_layout(resnet.init_params(torch.Generator()),
                                total_multiple=2048)
    ref = ref_flatten.build_layout(ref_shapes, total_multiple=2048)
    _assert_same_layout(mine, ref)
    assert mine.n_flat == 11_175_936
    assert mine.n_params == 11_173_461


def test_full_width_leaf_order_is_jax_order():
    ref_shapes = jax.eval_shape(
        lambda: ref_resnet.init_params(jax.random.PRNGKey(0)))
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(ref_shapes)[0]]
    assert paths[0].startswith("['exit_head']")
    assert paths[-1] == "['stem']"
    mine = [tuple(x.shape) for x in tree_leaves(
        resnet.init_params(torch.Generator()))]
    assert mine == [tuple(x.shape) for x in jax.tree.leaves(ref_shapes)]


@pytest.mark.parametrize("total_multiple", [0, 128, 2048])
def test_narrow_layout_matches_reference(total_multiple):
    p, pn = _narrow_tree()
    _assert_same_layout(
        flatten.build_layout(p, total_multiple=total_multiple),
        ref_flatten.build_layout(pn, total_multiple=total_multiple))


def test_pack_unpack_bitwise_across_packages():
    p, pn = _narrow_tree(1)
    layout = flatten.build_layout(p, total_multiple=2048)
    ref_layout = ref_flatten.build_layout(pn, total_multiple=2048)
    flat = flatten.pack(layout, p)
    ref_flat = np.asarray(ref_flatten.pack(ref_layout, pn))
    np.testing.assert_array_equal(flat.numpy(), ref_flat)
    # a vector packed by either package unpacks in the other
    back = flatten.unpack(layout, torch.from_numpy(ref_flat.copy()))
    for a, b in zip(tree_leaves(back), tree_leaves(p)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    ref_back = ref_flatten.unpack(ref_layout, jnp.asarray(flat.numpy()))
    for a, b in zip(jax.tree.leaves(ref_back), jax.tree.leaves(pn)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_pack_stacked_bitwise_and_bf16():
    trees = [_narrow_tree(s) for s in range(3)]
    stacked = tree_map(lambda *xs: torch.stack(xs), *[t for t, _ in trees])
    ref_stacked = jax.tree.map(lambda *xs: jnp.stack(xs),
                               *[t for _, t in trees])
    layout = flatten.build_layout(trees[0][0], total_multiple=2048)
    ref_layout = ref_flatten.build_layout(trees[0][1], total_multiple=2048)
    for dt, rdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = flatten.pack_stacked(layout, stacked, dtype=dt).float()
        want = ref_flatten.pack_stacked(ref_layout, ref_stacked, dtype=rdt)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want.astype(jnp.float32)))
    # pack_into row by row gives the same buffer
    rows = torch.zeros((3, layout.n_flat))
    for z, (t, _) in enumerate(trees):
        flatten.pack_into(layout, t, rows[z])
    np.testing.assert_array_equal(
        rows.numpy(), flatten.pack_stacked(layout, stacked).numpy())


def test_pack_mask_bitwise():
    p, pn = _narrow_tree()
    layout = flatten.build_layout(p, total_multiple=2048)
    ref_layout = ref_flatten.build_layout(pn, total_multiple=2048)
    got = flatten.pack_mask(layout, masking.resnet_subnet_mask(p))
    want = ref_flatten.pack_mask(ref_layout,
                                 ref_masking.resnet_subnet_mask(pn))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.bool


def test_interop_round_trip_is_exact():
    p, pn = _narrow_tree(2)
    back = interop.to_reference(interop.from_reference(pn))
    assert jax.tree.structure(back) == jax.tree.structure(pn)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(pn)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_auto_cohort_chunk_matches_reference():
    p, pn = _narrow_tree()
    layout = flatten.build_layout(p, total_multiple=2048)
    ref_layout = ref_flatten.build_layout(pn, total_multiple=2048)
    for budget in (1e5, 1e6, 1e9):
        for dt, rdt, qb in ((torch.float32, jnp.float32, 0),
                            (torch.bfloat16, jnp.bfloat16, 0),
                            (torch.int8, jnp.int8, 32)):
            assert flatten.auto_cohort_chunk(
                layout, budget_bytes=budget, k=7, stream_dtype=dt,
                quant_block=qb) == \
                ref_flatten.auto_cohort_chunk(
                    ref_layout, budget_bytes=budget, k=7, stream_dtype=rdt,
                    quant_block=qb)
            assert layout.stream_bytes(dt, quant_block=qb) == \
                ref_layout.stream_bytes(rdt, quant_block=qb)
