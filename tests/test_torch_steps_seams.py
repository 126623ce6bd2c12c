"""Port parity of the launch-side round step's engines and seams: the tree
engine and decouple, the async engine's staleness weights
(``tests/test_async.py::test_fed_round_step_staleness_weights``), the
uniform sampler's pad slots (``real``) and a NaN client, each against the
reference's own ``make_fed_round_step`` jitted on the CPU.  Setup and
rules as in ``test_torch_steps.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro.core import aggregate as ref_aggregate  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models.common import NO_POLICY  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.core import aggregate  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_steps import (  # noqa: E402
    CFG, IS_SIMPLE, K, REF_CFG, STEPS, assert_round_matches,
    assert_tree_close, port_round, ref_params, ref_round, tokens)


def test_tree_round_matches_reference():
    data = tokens()
    ref_spec = ref_aggregate.EngineSpec(engine="tree", algorithm="fedhen")
    spec = aggregate.EngineSpec(engine="tree", algorithm="fedhen")
    assert_round_matches(
        port_round(data, local_steps=STEPS, cohort_chunk=2, engine=spec),
        ref_round(data, local_steps=STEPS, cohort_chunk=2, engine=ref_spec))


def test_decouple_round_matches_reference():
    data = tokens()
    ref_spec = ref_aggregate.EngineSpec(algorithm="decouple", block_n=512)
    spec = aggregate.EngineSpec(algorithm="decouple", block_n=512)
    assert_round_matches(
        port_round(data, local_steps=STEPS, cohort_chunk=2, engine=spec),
        ref_round(data, local_steps=STEPS, cohort_chunk=2, engine=ref_spec))


def test_staleness_weights_match_reference():
    """All-zero staleness is the synchronous fold bitwise; ``[2, 0, 2,
    0]`` reweights the fold (the loss, a training metric, is unchanged)
    as the reference's does."""
    data = tokens()
    kw = dict(local_steps=STEPS, cohort_chunk=2)
    sync_c, sync_loss = port_round(data, **kw)
    zero_c, zero_loss = port_round(data, IS_SIMPLE, None,
                                   torch.zeros((K,), dtype=torch.int32),
                                   **kw)
    assert torch.equal(sync_loss, zero_loss)
    for a, b in zip(tree_leaves(sync_c), tree_leaves(zero_c)):
        assert torch.equal(a, b)
    stale = np.array([2, 0, 2, 0], np.int32)
    got = port_round(data, IS_SIMPLE, None, torch.as_tensor(stale), **kw)
    assert_round_matches(got, ref_round(data, IS_SIMPLE, None,
                                        jnp.asarray(stale), **kw))
    assert float(got[1]) == float(sync_loss)
    assert any(not torch.equal(a, b)
               for a, b in zip(tree_leaves(got[0]), tree_leaves(sync_c)))


def test_pad_slots_match_reference():
    """A ``real=False`` slot folds at weight 0 and leaves the loss mean,
    whose denominator is the real slots' count."""
    data = tokens()
    real = np.array([True, False, True, True])
    kw = dict(local_steps=STEPS, cohort_chunk=2)
    got = port_round(data, IS_SIMPLE, None, None, torch.as_tensor(real),
                     **kw)
    assert_round_matches(got, ref_round(data, IS_SIMPLE, None, None,
                                        jnp.asarray(real), **kw))
    sync = port_round(data, **kw)
    assert float(got[1]) != float(sync[1])


def test_nan_client_folds_at_weight_zero():
    """A client that trains to NaN (a NaN final-norm scale) is excluded
    from the fold by its finiteness, as in the reference; the reported
    loss is NaN in both."""
    stacked = jax.tree.map(
        lambda x: np.array(np.broadcast_to(np.asarray(x)[None],
                                           (K,) + x.shape)), ref_params())
    stacked["final_norm"]["scale"][2] = np.nan
    data = tokens()
    step = steps.make_fed_round_step(CFG, local_steps=STEPS, cohort_chunk=2)
    new_c, loss = step(interop.from_reference(stacked), torch.as_tensor(data),
                       torch.as_tensor(IS_SIMPLE))
    r_c, r_loss = jax.jit(ref_steps.make_fed_round_step(
        REF_CFG, NO_POLICY, local_steps=STEPS, cohort_chunk=2))(
        jax.tree.map(jnp.asarray, stacked), jnp.asarray(data),
        jnp.asarray(IS_SIMPLE))
    assert np.isnan(float(loss)) and np.isnan(float(r_loss))
    assert all(torch.isfinite(x).all() for x in tree_leaves(new_c))
    assert_tree_close(new_c, r_c)
