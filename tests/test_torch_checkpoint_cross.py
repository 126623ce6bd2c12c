"""Trainer checkpoints crossing between the packages, in both
directions, tree and flat formats, for the narrow PreActResNet18-GN and
``attn4``: a checkpoint the port saves restores through
``repro.checkpoint.checkpoint.restore_trainer`` into a reference trainer,
and the reverse; the server leaves bitwise, the round counter, the
client-state matrix, and a SCAFFOLD trainer's control variates (exact).

The port's side trains one round first; the reference's side gets a
server of its own (the start weights scaled and shifted, round 3) and a
recorded round, so no reference round needs compiling.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro.checkpoint import checkpoint as ref_ck  # noqa: E402
from repro.core.federated import ServerState as RefServerState  # noqa

from test_torch_async_lm import make_async_pair  # noqa: E402
from test_torch_round import ROUND as RESNET_ROUND  # noqa: E402
from test_torch_round import make_pair, make_shards  # noqa: E402
from test_torch_round_lm import ROUND as LM_ROUND  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint import checkpoint as ck  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


def pair(model, **kw):
    if model == "resnet":
        return make_pair(make_shards(), **RESNET_ROUND, **kw)
    return make_async_pair("attn4", **LM_ROUND, **kw)


def assert_same_as_reference(mine, theirs):
    want = interop.from_reference(jax.tree.map(np.asarray, theirs))
    la, lb = tree_leaves(mine), tree_leaves(want)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


CASES = [(m, f, a) for m in ("resnet", "attn4") for f in ("tree", "flat")
         for a in ("fedhen", "decouple")]


@pytest.mark.parametrize("model,fmt,algorithm", CASES)
def test_port_checkpoint_restores_in_the_reference(tmp_path, model, fmt,
                                                   algorithm):
    port, ref = pair(model, algorithm=algorithm)
    port.run_round()
    path = str(tmp_path / "port.ckpt")
    ck.save_trainer(path, port, fmt=fmt)
    ref_ck.restore_trainer(path, ref, fmt=fmt)
    assert ref.server.round == port.server.round == 1
    assert_same_as_reference(port.server.complex, ref.server.complex)
    if algorithm == "decouple":
        assert_same_as_reference(port.server.simple_host,
                                 ref.server.simple_host)
    np.testing.assert_array_equal(ref.client_state.array,
                                  port.client_state.array)


@pytest.mark.parametrize("model,fmt,algorithm", CASES)
def test_reference_checkpoint_restores_in_the_port(tmp_path, model, fmt,
                                                   algorithm):
    port, ref = pair(model, algorithm=algorithm)
    bump = lambda t: jax.tree.map(lambda x: (x * 2 + 1).astype(x.dtype), t)
    ref.server = RefServerState(
        complex=bump(ref.server.complex),
        simple_host=(bump(ref.server.simple_host)
                     if algorithm == "decouple" else None), round=3)
    plan = ref.sampler.plan(2)
    ref.client_state.record_round(plan.real_ids(), 2)
    path = str(tmp_path / "ref.ckpt")
    ref_ck.save_trainer(path, ref, fmt=fmt)
    ck.restore_trainer(path, port, fmt=fmt)
    assert port.server.round == 3
    assert_same_as_reference(port.server.complex, ref.server.complex)
    if algorithm == "decouple":
        assert_same_as_reference(port.server.simple_host,
                                 ref.server.simple_host)
    np.testing.assert_array_equal(port.client_state.array,
                                  ref.client_state.array)


def test_scaffold_sidecars_cross_both_ways(tmp_path):
    port, ref = pair("attn4", algorithm="fedhen",
                     variance_reduction="scaffold")
    port.run_round()
    path = str(tmp_path / "port.ckpt")
    ck.save_trainer(path, port)
    ref_ck.restore_trainer(path, ref)
    ids = np.arange(port.fed.n_devices)
    np.testing.assert_array_equal(ref.cv_store.to_array(),
                                  port.cv_store.gather(ids).numpy())
    np.testing.assert_array_equal(np.asarray(ref.cv_global),
                                  port.cv_global.numpy())
    back, _ = pair("attn4", algorithm="fedhen",
                   variance_reduction="scaffold")
    path = str(tmp_path / "ref.ckpt")
    ref_ck.save_trainer(path, ref, fmt="flat")
    ck.restore_trainer(path, back, fmt="flat")
    assert torch.equal(back.cv_global, port.cv_global)
    assert torch.equal(back.cv_store.gather(ids), port.cv_store.gather(ids))
    assert_same_as_reference(back.server.complex, ref.server.complex)
