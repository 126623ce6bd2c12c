"""Port parity of async rounds on ``attn4`` (the attention-only config of
every committed BENCH row) against the reference's ``AsyncRoundEngine``:
fedhen and decouple at lag 1 and 3, three rounds each.

Setup as in ``test_torch_round_lm.py`` (4 clients, participation 1.0,
``cohort_chunk=1``, so F = 4 folds a round: lag 1 makes the first simple
chunk one round stale, lag 3 the first three chunks), minibatch order
from the reference's keys (``ReferenceSchedule``: the async round keys
its clients as the sync round does).  Tolerances those of
``test_torch_round.assert_round_matches`` (server params rtol 1e-4 / atol
1e-5, losses atol 1e-5, ``n_valid`` exactly); the bytes billed each round
(down and up, with the stale-reuse savings) and the version-cache counts
exactly.
"""

import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro.configs.base import FedConfig as RefFedConfig  # noqa: E402
from repro.core.adapters import LMAdapter as RefLMAdapter  # noqa: E402
from repro.core.federated import FederatedTrainer as RefTrainer  # noqa

from test_torch_round import assert_round_matches  # noqa: E402
from test_torch_round_lm import ROUND, lm_shards  # noqa: E402
from test_torch_round_schedule import ReferenceSchedule  # noqa: E402
from torch_lm_cases import config_pair  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.core.adapters import LMAdapter  # noqa: E402
from repro_torch.core.federated import FederatedTrainer  # noqa: E402


def make_async_pair(case, n_clients=4, overrides=None, **kw):
    """(port trainer, reference trainer) of LM ``case`` (its configs
    with ``overrides``) over ``n_clients`` shards, from the same weights
    and minibatch order."""
    ref_cfg, cfg = config_pair(case)
    if overrides:
        ref_cfg = ref_cfg.with_overrides(**overrides)
        cfg = cfg.with_overrides(**overrides)
    shards = lm_shards(cfg.vocab_size, n_clients)
    port = FederatedTrainer(LMAdapter(cfg), FedConfig(**kw), shards,
                            device="cpu",
                            generator=torch.Generator().manual_seed(0),
                            schedule=ReferenceSchedule(0, kw["local_epochs"]))
    start = interop.to_reference(port.server.complex)

    class SameStart(RefLMAdapter):
        def init(self, key):
            return jax.tree.map(jnp.asarray, start)

    ref = RefTrainer(SameStart(ref_cfg), RefFedConfig(**kw),
                     [{k: jnp.asarray(v) for k, v in s.items()}
                      for s in shards])
    return port, ref


def run_async_pair(port, ref, rounds=3, check=assert_round_matches):
    """``rounds`` async rounds of each, held round by round by
    ``check``."""
    mine, theirs = port.async_engine, ref.async_engine
    assert (mine.folds_per_round, mine.n_versions) == \
        (theirs.folds_per_round, theirs.n_versions)
    for _ in range(rounds):
        r = port.server.round
        assert r == ref.server.round
        assert [list(s) for s in mine.schedule(r)] == \
            [list(s) for s in theirs.schedule(r)]
        check(port, ref, port.run_round(), ref.run_round())
        assert (mine.last_bytes_down, mine.last_bytes_up) == \
            (theirs.last_bytes_down, theirs.last_bytes_up)
        assert (port.total_bytes_down, port.total_bytes_up) == \
            (ref.total_bytes_down, ref.total_bytes_up)
        assert (mine.cache_hits, mine.cache_misses) == \
            (theirs.cache_hits, theirs.cache_misses)


@pytest.mark.parametrize("algorithm,lag", [("fedhen", 1), ("fedhen", 3),
                                           ("decouple", 1), ("decouple", 3)])
def test_async_lm_rounds_match_reference(algorithm, lag):
    port, ref = make_async_pair("attn4", algorithm=algorithm, async_lag=lag,
                                **ROUND)
    run_async_pair(port, ref)
    # stale chunks reused broadcasts their clients already held
    assert port.async_engine.cache_hits > 0
    assert port.total_bytes_down < 3 * port.bytes_down_per_round
