"""The launch plans of the redesigned fold kernels, on the CPU.

K4 (``masked_agg_fold_``) folds every leaf of a packed layout in one launch
from a leaf table and a work list of ``(leaf, tile)`` items built once per
layout (:class:`ops.FoldPlan`); K3 (``masked_scatter_acc_``) first finds,
in one parallel pass, each row's run of entries in every span of the
accumulator and the spans that have entries.  The kernels run only on the
card; what they are given is checked here: the tables' coverage, the
cache, the fused fold's plain version (bitwise against the per-leaf sum,
and within 1e-6 of the reference's per-leaf kernel plus add, which sums
the rows in the same order), and the bounds pass's plain version against
``torch.searchsorted``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro.kernels.masked_agg import ops as ref_ops  # noqa: E402

from repro_torch.core import flatten  # noqa: E402
from repro_torch.core.adapters import ResNetAdapter  # noqa: E402
from repro_torch.kernels.masked_agg import ops  # noqa: E402
from repro_torch.kernels.masked_agg.ref import (  # noqa: E402
    masked_agg_fold_ref, masked_agg_ref, scatter_bounds_ref)

TOL = dict(rtol=1e-6, atol=1e-6)


def _resnet_layout():
    params = ResNetAdapter(10).init(torch.Generator().manual_seed(0), "cpu")
    return flatten.build_layout(params, total_multiple=2048)


def _ragged_tree():
    """Leaves of 1, 3, 10 and 4,097 elements (ragged against the tile and
    the 16-byte vector) and one of exactly two tiles."""
    return {"a": torch.zeros(1), "b": torch.zeros(3),
            "c": torch.zeros(2, 5), "d": torch.zeros(4097),
            "e": torch.zeros(2 * ops.TILE)}


def _covered(layout, leaves, items):
    """How often the work list writes each element of a packed row."""
    counts = np.zeros(layout.n_flat, np.int64)
    lv = leaves.numpy()
    for leaf, tile in items.tolist():
        x_off, size, out_off = lv[leaf]
        assert x_off == out_off
        lo = tile * ops.TILE
        hi = min(lo + ops.TILE, size)
        assert 0 <= lo < hi
        counts[out_off + lo:out_off + hi] += 1
    return counts


@pytest.mark.parametrize("which", ["resnet", "ragged"])
def test_fold_tables_cover_every_leaf_element_once(which):
    layout = (_resnet_layout() if which == "resnet"
              else flatten.build_layout(_ragged_tree()))
    leaves, items = ops.fold_tables(layout.slots)
    assert leaves.dtype == torch.int64 and items.dtype == torch.int32
    assert leaves.tolist() == [[s.offset, s.size, s.offset]
                               for s in layout.slots]
    counts = _covered(layout, leaves, items)
    in_leaf = np.zeros(layout.n_flat, bool)
    for s in layout.slots:
        in_leaf[s.offset:s.offset + s.size] = True
    assert (counts[in_leaf] == 1).all()
    assert (counts[~in_leaf] == 0).all()          # no padding is written
    want_items = sum(-(-s.size // ops.TILE) for s in layout.slots)
    assert items.shape == (want_items, 2)


def test_fold_plan_is_built_once_per_layout_signature():
    a = flatten.build_layout(_ragged_tree())
    b = flatten.build_layout(_ragged_tree())        # equal, not the same
    assert a is not b and a.signature == b.signature
    plan = ops.fold_plan(a, "cpu")
    assert ops.fold_plan(b, "cpu") is plan
    other = flatten.build_layout({"a": torch.zeros(7)})
    assert ops.fold_plan(other, "cpu") is not plan
    assert plan.length == max(s.offset + s.size for s in a.slots)


def _fold_inputs(layout, z, seed):
    """Row 1 NaN at weight 0 on both branches, row 2 weight 0 inside M
    only, row 3 a zero-weight slot."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(z, layout.n_flat)).astype(np.float32)
    x[1] = np.nan
    mask = rng.random(layout.n_flat) < 0.4
    w_m = rng.uniform(0.2, 1.5, size=z).astype(np.float32)
    w_rest = rng.uniform(0.2, 1.5, size=z).astype(np.float32)
    w_m[1] = w_rest[1] = w_m[2] = w_m[3] = w_rest[3] = 0.0
    acc = rng.normal(size=layout.n_flat).astype(np.float32)
    return acc, x, mask, w_m, w_rest


@pytest.mark.parametrize("which", ["resnet", "ragged"])
def test_fused_fold_is_acc_plus_each_leafs_one_shot_sum(which):
    layout = (_resnet_layout() if which == "resnet"
              else flatten.build_layout(_ragged_tree()))
    acc, x, mask, w_m, w_rest = (torch.from_numpy(a) for a in
                                 _fold_inputs(layout, 5, seed=3))
    plan = ops.fold_plan(layout, "cpu")
    got = acc.clone()
    before = ops.masked_agg_fold_.launches
    assert ops.masked_agg_fold_(got, x, mask, w_m, w_rest, plan) is got
    assert ops.masked_agg_fold_.launches == before   # the CPU launches none
    want = acc.clone()
    for s in layout.slots:
        o = slice(s.offset, s.offset + s.size)
        want[o] = acc[o] + masked_agg_ref(x[:, o], mask[o], w_m, w_rest)
    assert torch.equal(got, want)                    # bitwise, padding too
    assert bool(torch.isfinite(got).all())


def test_fused_fold_matches_reference_tree_kernel_plus_add():
    layout = flatten.build_layout(_ragged_tree())
    acc, x, mask, w_m, w_rest = _fold_inputs(layout, 5, seed=4)
    got = ops.masked_agg_fold_(torch.from_numpy(acc.copy()),
                               torch.from_numpy(x), torch.from_numpy(mask),
                               torch.from_numpy(w_m),
                               torch.from_numpy(w_rest),
                               ops.fold_plan(layout, "cpu"))
    for s in layout.slots:
        o = slice(s.offset, s.offset + s.size)
        leaf = jnp.asarray(x[:, o]).reshape((5,) + s.shape)
        part = ref_ops.masked_agg_leaf(
            leaf, jnp.asarray(mask[o]).reshape(s.shape), jnp.asarray(w_m),
            jnp.asarray(w_rest), force_pallas_interpret=True)
        want = jnp.asarray(acc[o]).reshape(s.shape) + part
        np.testing.assert_allclose(got[o].numpy(),
                                   np.asarray(want).reshape(-1), **TOL)


def test_fused_fold_plain_version_leaves_uncovered_elements_alone():
    leaves = torch.tensor([[0, 3, 10], [5, 2, 1]])
    acc = torch.arange(16, dtype=torch.float32)
    x = torch.ones((2, 8))
    mask = torch.ones(16, dtype=torch.bool)
    out = masked_agg_fold_ref(acc, x, mask, torch.ones(2), torch.ones(2),
                              leaves)
    want = acc.clone()
    want[10:13] += 2.0
    want[1:3] += 2.0
    assert torch.equal(out, want)


@pytest.mark.parametrize("broken", ["x_dtype", "short_acc", "mask_shape",
                                    "plan_device"])
def test_fused_fold_rejects_what_the_kernel_does_not_take(broken):
    layout = flatten.build_layout(_ragged_tree())
    acc, x, mask, w_m, w_rest = (torch.from_numpy(a) for a in
                                 _fold_inputs(layout, 4, seed=5))
    plan = ops.fold_plan(layout, "cpu")
    if broken == "x_dtype":
        x = x.to(torch.bfloat16)       # the engine widens a bf16 stream
    elif broken == "short_acc":
        acc, mask = acc[:100], mask[:100]
    elif broken == "mask_shape":
        mask = mask[:-1]
    else:
        plan = plan._replace(leaves=plan.leaves.to("meta"))
    with pytest.raises(ValueError):
        ops.masked_agg_fold_(acc, x, mask, w_m, w_rest, plan)


def _searchsorted_runs(idx, n, span):
    """(start, end) of each row's entries in each span by binary search."""
    n_spans = -(-n // span)
    edges = torch.arange(n_spans + 1, dtype=torch.int64) * span
    lo = torch.searchsorted(idx.to(torch.int64), edges[:-1])
    hi = torch.searchsorted(idx.to(torch.int64), edges[1:])
    return lo, hi


@pytest.mark.parametrize("n,span", [(10_000, 1024), (4096, 1024),
                                    (100_003, 4096)])
def test_scatter_bounds_match_searchsorted(n, span):
    rng = np.random.default_rng(n)
    z, k = 6, 256
    pool = np.setdiff1d(np.arange(n), np.arange(2 * span, 3 * span))
    rows = [np.sort(rng.choice(pool, size=k, replace=False))
            for _ in range(z)]
    rows[0][0], rows[0][-1] = 0, n - 1        # the first and last position
    rows[3] = np.sort(rng.choice(span, size=k, replace=False))  # one span
    idx = torch.from_numpy(np.stack(rows).astype(np.int32))
    w_m = torch.tensor([1.0, 0.0, 0.5, 1.0, 0.0, 2.0])
    w_rest = torch.tensor([0.0, 0.0, 0.5, 1.0, 0.7, 0.0])  # row 1 dead
    start, end, live = scatter_bounds_ref(idx, w_m, w_rest, n, span)
    n_spans = -(-n // span)
    assert start.shape == end.shape == (z, n_spans)
    any_entry = torch.zeros(n_spans, dtype=torch.bool)
    for r in range(z):
        if r == 1:                             # both weights 0: no runs
            assert not start[r].any() and not end[r].any()
            continue
        lo, hi = _searchsorted_runs(idx[r], n, span)
        has = hi > lo
        assert torch.equal(start[r][has].long(), lo[has])
        assert torch.equal(end[r][has].long(), hi[has])
        assert torch.equal(start[r][~has], end[r][~has])   # empty run
        any_entry |= has
    assert torch.equal(live, torch.nonzero(any_entry).flatten())
    assert not bool(any_entry[2])              # a span with no entries
    assert bool(any_entry[0]) and bool(any_entry[-1])


def test_scatter_bounds_of_rows_without_entries_are_empty():
    start, end, live = scatter_bounds_ref(
        torch.zeros((2, 0), dtype=torch.int32), torch.ones(2), torch.ones(2),
        5000, 1024)
    assert start.shape == (2, 5) and not start.any() and not end.any()
    assert live.numel() == 0


def test_scatter_bounds_drop_indices_outside_the_accumulator():
    idx = torch.tensor([[-3, 2, 2047, 5000]], dtype=torch.int32)
    start, end, live = scatter_bounds_ref(idx, torch.ones(1), torch.ones(1),
                                          4096, 1024)
    # -3 counts in span 0 (the kernel drops it there); 5000 is past n
    assert start.tolist() == [[0, 2, 0, 0]]
    assert end.tolist() == [[2, 3, 0, 0]]
    assert live.tolist() == [0, 1]


@pytest.mark.parametrize("n,z,k,want", [
    (11_175_936, 5, 798_208, 4096), (11_175_936, 5, 48_384, 4096),
    (11_175_936, 5, 11_175_936, 1024), (1_000, 3, 128, 4096),
    (100_000, 40, 100_000, 1024)])
def test_scatter_span_keeps_a_span_inside_the_staging_room(n, z, k, want):
    span = ops.scatter_span(n, z, k)
    assert span == want
    assert span & (span - 1) == 0
    assert ops.SCATTER_SPAN[0] <= span <= ops.SCATTER_SPAN[1]
    if span > ops.SCATTER_SPAN[0]:
        assert z * k * span <= ops.SCATTER_STAGE * n
