"""The port's async engine (``repro_torch.core.async_rounds``): the
schedule and the staleness weights against the reference's functions
(bitwise), dispatch, lag-0 parity with the port's own synchronous engine
(bitwise: server params, metrics and bytes, for fedhen, noside, decouple,
the int8 wire and the tree engine), version-aware billing against
``comm.VersionCache``'s dict semantics, the reset on an outside server
replacement, and a bf16 model's async rounds (its stale versions kept as
bf16 trees) against the reference's ``AsyncRoundEngine`` (f32 version
rows), at ``BF16_ATOL``.

Setup: ``attn4`` (``torch_lm_cases``) over 12 clients, participation
0.5 and ``cohort_chunk=2``, so each population's 3 clients make 2 chunks
(one padded with a weight-0 slot): F = 4 folds a round.  The bf16
rounds take ``test_torch_async_lm.py``'s setup (4 clients, chunk 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro.core import async_rounds as ref_async  # noqa: E402
from repro.core import comm as ref_comm  # noqa: E402

from test_torch_async_lm import make_async_pair, run_async_pair  # noqa
from test_torch_round_lm import ROUND  # noqa: E402
from torch_lm_cases import config_pair  # noqa: E402

from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.core import async_rounds, comm  # noqa: E402
from repro_torch.core.adapters import LMAdapter  # noqa: E402
from repro_torch.core.federated import (FederatedTrainer,  # noqa: E402
                                        ServerState)
from repro_torch.data.federated import iid_split  # noqa: E402
from repro_torch.data.synthetic import synthetic_lm  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

# gemma2-2b-deep in bf16 at lag 0: the port's params differ from the
# reference's by up to 1.95e-3, its losses by up to 1.1e-3.  At lag 3 a
# port that trained the stale chunks on the fresh model misses the
# reference's complex loss by 0.21 at round 1.
BF16_ATOL = 2e-3


def make_trainer(algorithm="fedhen", *, n_devices=12, chunk=2,
                 participation=0.5, cfg=None, **fed_kw):
    cfg = cfg if cfg is not None else config_pair("attn4")[1]
    fed = FedConfig(n_devices=n_devices, n_simple=n_devices // 2,
                    participation=participation, local_epochs=1, lr=0.1,
                    batch_size=4, algorithm=algorithm, seed=0,
                    cohort_chunk=chunk, **fed_kw)
    data = synthetic_lm(n_devices * 4, 16, cfg.vocab_size, seed=1)
    shards = [{"tokens": s["tokens"]}
              for s in iid_split(data, n_devices, seed=2)]
    return FederatedTrainer(LMAdapter(cfg), fed, shards, device="cpu",
                            generator=torch.Generator().manual_seed(0))


def same(a, b) -> bool:
    return all(torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


# -- schedule and weights ----------------------------------------------------

def test_fold_schedule_matches_reference():
    np.testing.assert_array_equal(async_rounds.fold_schedule(4, 5, 10),
                                  [2, 1, 1, 1])
    np.testing.assert_array_equal(async_rounds.fold_schedule(4, 5, 0),
                                  [0, 0, 0, 0])
    for n_folds in range(1, 6):
        for lag in range(8):
            for r in range(4):
                np.testing.assert_array_equal(
                    async_rounds.fold_schedule(n_folds, lag, r),
                    ref_async.fold_schedule(n_folds, lag, r))


@pytest.mark.parametrize("decay", [0.0, 0.25, 0.5, 1.0, 2.0])
def test_staleness_weight_is_bitwise_the_reference(decay):
    s = np.arange(9)
    got = async_rounds.staleness_weight(s, decay=decay)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    want = np.asarray(ref_async.staleness_weight(s, decay=decay))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0].item() == 1.0                  # the lag-0 parity bit
    np.testing.assert_array_equal(
        async_rounds.staleness_weight(s, scheme="none").numpy(),
        np.asarray(ref_async.staleness_weight(s, scheme="none")))
    with pytest.raises(ValueError):
        async_rounds.staleness_weight(s, scheme="exp")


def test_config_accepts_async_and_rejects_bad_values():
    assert FedConfig(async_lag=2).async_lag == 2
    for bad in (dict(async_lag=-1), dict(async_staleness="exp"),
                dict(async_decay=-0.5)):
        with pytest.raises(ValueError):
            FedConfig(**bad)


# -- dispatch and lag-0 parity -----------------------------------------------

def test_trainer_dispatches_to_async_engine():
    assert make_trainer().async_engine is None
    tr = make_trainer(async_lag=2)
    eng = tr.async_engine
    assert isinstance(eng, async_rounds.AsyncRoundEngine) and eng.lag == 2
    # 3 clients a population at chunk 2: 2 chunks each, 4 folds a round;
    # lag 2 < F: the fresh model and one round back
    assert (eng.folds_per_round, eng.n_versions) == (4, 2)
    assert len(eng.versions()) == 2
    m = tr.run_round()
    assert np.isfinite(m["loss_complex"]) and np.isfinite(m["loss_simple"])
    assert tr.server.round == 1


@pytest.mark.parametrize("algorithm,extra", [
    ("fedhen", {}), ("noside", {}), ("decouple", {}),
    ("fedhen", dict(comm_dtype="int8")), ("fedhen", dict(agg_engine="tree"))],
    ids=["fedhen", "noside", "decouple", "int8", "tree"])
def test_lag0_is_bitwise_the_sync_round(algorithm, extra):
    """At lag 0 the async path (versions, per-chunk sources, f32 weights)
    IS the synchronous round: server params, metrics and bytes equal."""
    sync = make_trainer(algorithm, **extra)
    tr = make_trainer(algorithm, **extra)
    eng = async_rounds.AsyncRoundEngine(tr, lag=0)
    for _ in range(2):
        assert sync.run_round() == eng.run_round()
    assert same(sync.server.complex, tr.server.complex)
    if algorithm == "decouple":
        assert same(sync.server.simple_host, tr.server.simple_host)
    assert (tr.total_bytes_down, tr.total_bytes_up) == \
        (sync.total_bytes_down, sync.total_bytes_up)


def test_staleness_weighting_is_live():
    a = make_trainer(async_lag=3, async_decay=0.5)
    b = make_trainer(async_lag=3, async_staleness="none")
    for _ in range(3):
        a.run_round()
        b.run_round()
    assert not same(a.server.complex, b.server.complex)


def assert_bf16_round_matches(port, ref, port_metrics, ref_metrics):
    """``assert_round_matches`` for a bf16 model, at ``BF16_ATOL``."""
    for key in ("loss_simple", "loss_complex"):
        np.testing.assert_allclose(port_metrics[key], ref_metrics[key],
                                   rtol=0, atol=BF16_ATOL)
    assert port_metrics["n_valid"] == ref_metrics["n_valid"]
    assert port.bytes_per_round == ref.bytes_per_round
    for a, b in zip(tree_leaves(port.server.complex),
                    jax.tree.leaves(ref.server.complex)):
        assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32),
                                   rtol=0, atol=BF16_ATOL)


def test_bf16_async_rounds_match_reference():
    """A bf16 model at lag 3 (F = 4: rounds 1-2 train three chunks on the
    one-round-stale model): the port's bf16 stale trees against the
    reference's f32 version stack."""
    port, ref = make_async_pair(
        "gemma2-2b-deep", overrides=dict(param_dtype="bfloat16",
                                         compute_dtype="bfloat16"),
        algorithm="fedhen", async_lag=3, **ROUND)
    run_async_pair(port, ref, check=assert_bf16_round_matches)
    assert port.async_engine.cache_hits > 0


# -- billing -----------------------------------------------------------------

def test_version_cache_bills_once_per_version():
    for cache in (comm.VersionCache(), ref_comm.VersionCache()):
        assert cache.bill(7, 0, 100) == 100     # first fetch
        assert cache.bill(7, 0, 100) == 0       # cached
        assert cache.holds(7, 0) and not cache.holds(7, 1)
        assert cache.bill(7, 1, 100) == 100     # new version
        assert cache.bill(7, 0, 100) == 100     # old version evicted
        assert cache.bill(8, 0, 100) == 100     # per-client ledger
        assert (cache.hits, cache.misses) == (1, 4)


@pytest.mark.parametrize("lag", [1, 3, 5])
def test_engine_billing_equals_the_version_cache(lag):
    """Each round's download equals ``VersionCache.bill`` called per real
    client with the tag its chunk trains on (round - staleness)."""
    tr = make_trainer(async_lag=lag, participation=0.75)
    eng, cache = tr.async_engine, comm.VersionCache()
    for r in range(4):
        plan = tr.sampler.plan(r)
        s_s, s_c = eng.schedule(r)
        want = 0
        for ids, real, s, chunk, nbytes in (
                (plan.simple_ids, plan.simple_real, s_s, eng.chunk_s,
                 tr.per_simple_bytes),
                (plan.complex_ids, plan.complex_real, s_c, eng.chunk_c,
                 tr.per_complex_bytes)):
            for pos, (cid, ok) in enumerate(zip(ids, real)):
                if ok:
                    want += cache.bill(int(cid), r - int(s[pos // chunk]),
                                       nbytes)
        tr.run_round()
        assert eng.last_bytes_down == want
        assert eng.last_bytes_up == tr.bytes_up_per_round
        assert (eng.cache_hits, eng.cache_misses) == (cache.hits,
                                                      cache.misses)
    assert cache.hits > 0


def test_stale_broadcast_reuse_saves_download_bytes():
    sync = make_trainer(participation=1.0)
    tr = make_trainer(participation=1.0, async_lag=1)
    eng = tr.async_engine
    tr.run_round()                           # round 0: cold cache
    assert tr.total_bytes_down == sync.bytes_down_per_round
    tr.run_round()                           # round 1: chunk 0 is stale
    assert eng.last_bytes_down == \
        sync.bytes_down_per_round - eng.chunk_s * tr.per_simple_bytes
    assert eng.last_bytes_up == sync.bytes_up_per_round


def test_server_replacement_resets_versions():
    """A server replaced from outside (checkpoint restore) becomes every
    version, the clients' cached tags are wiped, and rounds go on from
    its counter."""
    tr = make_trainer(async_lag=2)
    eng = tr.async_engine
    tr.run_round()
    tr.run_round()                           # the versions carry history
    assert not same(eng.versions()[1], tr.server.complex)
    restored = ServerState(complex=tree_map(torch.ones_like,
                                            tr.server.complex), round=7)
    tr.server = restored
    seen = []
    real = eng._sources

    def watch(models):
        seen.append(models)
        return real(models)
    eng._sources = watch
    m = tr.run_round()
    assert all(v is restored.complex for v in seen[0])
    assert eng.cache_hits == 0               # tags wiped: all fetched anew
    assert np.isfinite(m["loss_complex"]) and tr.server.round == 8
    assert eng.versions()[1] is restored.complex
