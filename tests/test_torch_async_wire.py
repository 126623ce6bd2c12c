"""Port parity of async rounds against the reference's
``AsyncRoundEngine`` beyond the plain wire: the compressed wire (int8,
top-k 1/14, stochastic rounding, error feedback) at lag 1, SCAFFOLD at
lag 3, uniform sampling at lag 1, and a NaN client under lag 2.

Setups as in ``test_torch_async_lm.py`` (``attn4``, ``cohort_chunk=1``,
the reference's minibatch order and random bits).  Tolerances: on the
compressed wire the lossy-wire rules of ``test_torch_round_wire.py`` for
the server params and the EF rows, with the broadcast step of every
version the round could select, and losses atol 1e-5; SCAFFOLD's
``cv_global`` and rows rtol 1e-4 / atol 1e-5 as in
``test_torch_scaffold_rounds.py``; otherwise
``test_torch_round.assert_round_matches``'s.  Bytes billed and
version-cache counts exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro.configs.base import FedConfig as RefFedConfig  # noqa: E402
from repro.core.federated import FederatedTrainer as RefTrainer  # noqa

from test_torch_async_lm import make_async_pair, run_async_pair  # noqa
from test_torch_round_lm import ROUND  # noqa: E402
from test_torch_round_schedule import ReferenceSchedule  # noqa: E402
from test_torch_round_wire import (ReferenceBits, _flat,  # noqa: E402
                                   assert_held)
from test_torch_scaffold_rounds import \
    assert_scaffold_state_matches  # noqa: E402

from repro_torch import parity  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.core.federated import FederatedTrainer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

COMPRESSED = dict(comm_dtype="int8", topk_frac=1 / 14,
                  stochastic_rounding=True, error_feedback=True)


def test_compressed_ef_async_rounds_match_reference():
    port, ref = make_async_pair("attn4", algorithm="fedhen", async_lag=1,
                                **ROUND, **COMPRESSED)
    port.bits = ReferenceBits(0)
    layout, eng = port.layout, port.async_engine
    carry = torch.zeros(layout.n_flat)
    for _ in range(3):
        # the broadcast step of every version a chunk can train on
        bstep = torch.stack([parity.wire_step(port.wire,
                                              _flat(layout, v))
                             for v in eng.versions()]).amax(0)
        uploads = parity.UploadSteps()
        with uploads():
            got = port.run_round()
        want = ref.run_round()
        for key in ("loss_simple", "loss_complex"):
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=1e-5)
        assert got["n_valid"] == want["n_valid"]
        assert (port.total_bytes_down, port.total_bytes_up) == \
            (ref.total_bytes_down, ref.total_bytes_up)
        step = bstep + uploads.step + carry
        mine = _flat(layout, port.server.complex)
        theirs = _flat(layout, ref.server.complex)
        assert_held(mine, theirs, step)
        ids = np.arange(port.fed.n_devices)
        assert_held(port.ef_store.gather(ids),
                    torch.from_numpy(ref.ef_store.to_array().copy()),
                    step.expand(len(ids), -1))
        carry = carry + (mine - theirs).abs()
    assert eng.cache_hits == ref.async_engine.cache_hits > 0


def test_scaffold_async_rounds_match_reference():
    port, ref = make_async_pair("attn4", algorithm="fedhen", async_lag=3,
                                variance_reduction="scaffold", **ROUND)
    for _ in range(3):
        run_async_pair(port, ref, rounds=1)
        assert_scaffold_state_matches(port, ref)
    assert float(port.cv_global.abs().max()) > 0.0


def test_uniform_async_rounds_match_reference():
    port, ref = make_async_pair("attn4", n_clients=8, algorithm="fedhen",
                                async_lag=1, **dict(
                                    ROUND, n_devices=8, n_simple=4,
                                    participation=0.25, sample_uniform=True))
    assert not port.sampler.plan(0).all_real
    run_async_pair(port, ref)
    np.testing.assert_array_equal(port.client_state.array,
                                  ref.client_state.array)


class PortNanAdapter:
    """Params drift toward each client's data mean; a NaN shard trains a
    NaN client the fold must exclude (the reference's ``_NanAdapter``)."""

    def init(self, generator, device):
        return {"a": torch.zeros(4, device=device),
                "b": torch.zeros(4, device=device)}

    def subnet_mask(self, params):
        return {"a": True, "b": False}

    @staticmethod
    def _loss(params, batch):
        x = batch["x"]
        return (torch.mean((params["a"][None] - x) ** 2)
                + torch.mean((params["b"][None] - 2.0 * x) ** 2))

    loss_simple = loss_complex = loss_side = _loss


class RefNanAdapter:
    def init(self, key):
        return {"a": jnp.zeros((4,), jnp.float32),
                "b": jnp.zeros((4,), jnp.float32)}

    def subnet_mask(self, params):
        return {"a": jnp.asarray(True), "b": jnp.asarray(False)}

    @staticmethod
    def _loss(params, batch):
        x = batch["x"]
        return (jnp.mean((params["a"][None] - x) ** 2)
                + jnp.mean((params["b"][None] - 2.0 * x) ** 2))

    loss_simple = loss_complex = loss_side = _loss


def test_nan_client_excluded_under_lag_as_in_reference():
    kw = dict(n_devices=8, n_simple=4, participation=1.0, local_epochs=1,
              lr=0.1, batch_size=4, algorithm="fedhen", seed=0,
              cohort_chunk=1, async_lag=2)
    rng = np.random.default_rng(0)
    shards = [{"x": rng.normal(size=(8, 4)).astype(np.float32)}
              for _ in range(kw["n_devices"])]
    shards[1]["x"][0, 0] = np.nan              # a poisoned simple client
    port = FederatedTrainer(PortNanAdapter(), FedConfig(**kw), shards,
                            device="cpu", schedule=ReferenceSchedule(0, 1))
    ref = RefTrainer(RefNanAdapter(), RefFedConfig(**kw),
                     [{"x": jnp.asarray(s["x"])} for s in shards])
    for _ in range(4):
        got, want = port.run_round(), ref.run_round()
        assert got["n_valid"] == want["n_valid"] == 7
        for key in ("loss_simple", "loss_complex"):   # NaN where theirs is
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=1e-5)
        for a, b in zip(tree_leaves(port.server.complex),
                        jax.tree.leaves(ref.server.complex)):
            assert torch.isfinite(a).all()
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=1e-5)
    assert port.total_bytes == ref.total_bytes
