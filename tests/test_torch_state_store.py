"""Port parity of the per-client state: ``FlatStateStore`` (every backend)
and ``ClientStateMatrix``, held to the reference's after the same calls,
at exact equality.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro.core import client_state as ref_client_state  # noqa: E402
from repro.core import state_store as ref_state_store  # noqa: E402

from repro_torch.core import client_state, state_store  # noqa: E402


@pytest.mark.parametrize("backend", ["auto", "device", "host", "mmap"])
@pytest.mark.parametrize("nbytes", [0, 64 * 2**20, 64 * 2**20 + 1,
                                    4 * 2**30, 4 * 2**30 + 1, 4.47e9])
def test_resolve_backend_matches_reference(backend, nbytes):
    assert state_store.resolve_backend(backend, int(nbytes)) == \
        ref_state_store.resolve_backend(backend, int(nbytes))


def test_resolve_backend_rejects_unknown():
    with pytest.raises(ValueError):
        state_store.resolve_backend("disk", 1)


@pytest.mark.parametrize("backend", ["auto", "device", "host", "mmap"])
def test_flat_state_store_matches_reference(backend):
    n_clients, n_flat = 9, 384
    mine = state_store.FlatStateStore(n_clients, n_flat, backend=backend)
    ref = ref_state_store.FlatStateStore(n_clients, n_flat, backend=backend)
    assert mine.backend == ref.backend
    assert mine.nbytes == ref.nbytes
    rng = np.random.default_rng(0)
    for ids in ([0, 4, 8], [4, 1], [7], [2, 3, 5, 6]):
        rows = rng.normal(size=(len(ids), n_flat)).astype(np.float32)
        got = mine.gather(ids)
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref.gather(ids)))
        mine.scatter(ids, torch.from_numpy(rows))
        ref.scatter(ids, rows)
    everyone = mine.gather(np.arange(n_clients)).numpy()
    np.testing.assert_array_equal(everyone,
                                  np.asarray(ref.gather(np.arange(n_clients))))
    np.testing.assert_array_equal(everyone, ref.to_array())
    assert mine.gathered_bytes == ref.gathered_bytes
    assert mine.scattered_bytes == ref.scattered_bytes
    ref.close()


@pytest.mark.parametrize("backend", ["device", "host", "mmap"])
def test_gather_is_a_copy_and_scatter_takes_numpy(backend):
    store = state_store.FlatStateStore(3, 128, backend=backend)
    block = store.gather([1])
    store.scatter([1], np.ones((1, 128), np.float32))
    assert not block.any()
    assert bool((store.gather([1]) == 1).all())


def test_flat_state_store_rejects_empty_shapes():
    for n_clients, n_flat in ((0, 128), (4, 0)):
        with pytest.raises(ValueError):
            state_store.FlatStateStore(n_clients, n_flat)


def test_client_state_matrix_matches_reference():
    mine = client_state.ClientStateMatrix(12)
    ref = ref_client_state.ClientStateMatrix(12)
    rng = np.random.default_rng(1)
    for r in range(6):
        ids = rng.choice(12, size=4, replace=False)
        mine.record_round(ids, r)
        ref.record_round(ids, r)
        norms = rng.uniform(0, 3, size=4)
        mine.set_ef_scale(ids, norms)
        ref.set_ef_scale(ids, norms)
        mine.set_cv_scale(ids[:2], norms[:2])
        ref.set_cv_scale(ids[:2], norms[:2])
        tags = np.full(4, r // 2)
        assert mine.bill_downloads(ids, tags, 100.0) == \
            ref.bill_downloads(ids, tags, 100.0)
    np.testing.assert_array_equal(mine.array, ref.array)
    assert mine.columns == ref.columns
    assert mine.tracked_clients() == ref.tracked_clients()
    assert mine.participation_histogram() == ref.participation_histogram()
    np.testing.assert_array_equal(mine.gather([3, 12]), ref.gather([3, 12]))
