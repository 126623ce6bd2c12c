"""Port parity of SCAFFOLD on the lossy wires: two fedhen rounds on the
int8 wire (dense uploads through K2) here, two with error feedback on the
int8 wire (delta uploads, each client's EF row in a second store) in
``test_torch_scaffold_wire_ef.py`` and two on the compressed wire (int8,
top-k, stochastic rounding, error feedback) in
``test_torch_scaffold_wire_compressed.py`` (each file stays under 50 s),
with the reference's minibatch schedule and random bits.

The server params and EF rows are held to the lossy-wire rules of
``test_torch_round_wire.py``.  The control variates ride the same rules:
``dc = (x - y) / (K lr) - c`` moves by ``step / (K lr)`` where a flipped
rounding moved the broadcast ``x`` by one step, so ``cv_global`` and every
row are held to at most ``MAX_SHARE`` of the elements outside rtol 1e-4,
atol 1e-5 and every element within that tolerance plus that step (plus,
in the second round, the first round's difference).  Clients take two SGD
steps a round (1 per epoch), as the wire tests do.

On the compressed wire one client of the second round trains across a
ReLU kink: the port's decoded broadcast and correction differ from the
reference's by about 5e-7, and from those inputs the reference's own
client trainer lands where the port does, 7.5e-3 of that client's
elements away from where it lands from its own inputs.  So there the
rounds are held with :class:`ReferenceSpread`: each bound also takes what
the reference itself moves by between the two inputs, and the share
allowed outside the tolerance also takes the elements that alone puts
there.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro.core import comm as ref_comm  # noqa: E402
from repro.core.federated import make_client_trainer  # noqa: E402

from repro_torch import interop, parity  # noqa: E402
from repro_torch.core import flatten  # noqa: E402
from test_torch_round import ROUND, make_pair, make_shards  # noqa: E402
from test_torch_round_schedule import ReferenceSchedule  # noqa: E402
from test_torch_round_wire import (ReferenceBits, _flat,  # noqa: E402
                                   assert_held, assert_norms,
                                   run_and_compare)


class ReferenceSpread:
    """The reference's own spread over one round: each client trained by
    the reference's jitted client trainer from the port's in-round inputs
    (its decoded broadcast and correction, recorded as the port trains)
    and from the reference's own.  After a round under :meth:`round`,
    ``moved`` is ``(n_devices, n_flat)``: each trained client's
    ``|y_from_port_inputs - y_from_own_inputs|`` in its client's row, 0
    for clients that did not train."""

    def __init__(self, port, ref, seed: int = 0):
        self.port, self.ref, self.seed = port, ref, seed
        fed, adapter = ref.fed, ref.adapter
        side = (adapter.loss_side if fed.algorithm == "fedhen"
                else adapter.loss_complex)
        self.train = {
            pop: jax.jit(make_client_trainer(loss, fed,
                                             cv_layout=ref.layout))
            for pop, loss in (("simple", adapter.loss_simple),
                              ("complex", side))}
        self.broadcast = jax.jit(lambda p: ref_comm.broadcast_roundtrip(
            ref.wire, ref.layout, p))
        self.moved = None

    @contextlib.contextmanager
    def round(self):
        port, ref = self.port, self.ref
        r = ref.server.round
        x_own = self.broadcast(ref.server.complex)
        c_own = ref.cv_global
        rows_own = jnp.asarray(ref.cv_store.to_array())
        seen = {"simple": [], "complex": []}
        trainers = {}
        for pop, calls in seen.items():
            name = "train_" + pop
            trainers[name] = inner = getattr(port, name)

            def record(params, data, perms, corr=None, _inner=inner,
                       _calls=calls):
                _calls.append((params, corr))
                return _inner(params, data, perms, corr)

            setattr(port, name, record)
        try:
            yield self
        finally:
            for name, inner in trainers.items():
                setattr(port, name, inner)
        plan = ref.sampler.plan(r)
        pop_keys = jax.random.split(jax.random.PRNGKey(self.seed * 100003
                                                       + r))
        moved = torch.zeros((ref.fed.n_devices, ref.layout.n_flat))
        for (pop, ids), pop_key in zip((("simple", plan.simple_ids),
                                        ("complex", plan.complex_ids)),
                                       pop_keys):
            in_slice = ref.flat_mask if pop == "simple" else True
            for slot, (cid, (x_port, corr_port)) in enumerate(
                    zip(ids, seen[pop])):
                key = jax.random.fold_in(pop_key, slot)
                data = ref.client_data[cid]
                corr_own = jnp.where(in_slice, c_own - rows_own[cid], 0.0)
                # a spread is the reference's own only where the inputs
                # it starts from agree to the float tolerance
                for mine, theirs in (
                        (_flat(port.layout, x_port),
                         _flat(port.layout, x_own)),
                        (corr_port, torch.from_numpy(np.array(corr_own)))):
                    np.testing.assert_allclose(mine.numpy(), theirs.numpy(),
                                               rtol=1e-4, atol=1e-5)
                y_own, _ = self.train[pop](x_own, data, key, corr_own)
                y_port, _ = self.train[pop](
                    jax.tree.map(jnp.asarray, interop.to_reference(x_port)),
                    data, key, jnp.asarray(corr_port.numpy()))
                moved[cid] = (_flat(port.layout, y_port)
                              - _flat(port.layout, y_own)).abs()
        self.moved = moved


def two_scaffold_fedhen_rounds_on_a_lossy_wire(wire, *, spread=False):
    kw = dict(ROUND, local_epochs=2, algorithm="fedhen",
              variance_reduction="scaffold", **wire)
    port, ref = make_pair(make_shards(16, 4),
                          port_kw={"schedule": ReferenceSchedule(0, 2),
                                   "bits": ReferenceBits(0)}, **kw)
    watch = ReferenceSpread(port, ref) if spread else None
    inv_k_lr = 1.0 / (2 * port.fed.lr)
    n = port.layout.n_flat
    carry = [torch.zeros(n)]
    cv_carry = torch.zeros(n)
    rows_carry = torch.zeros((4, n))
    ids = np.arange(4)
    for _ in range(2):
        start = flatten.pack(port.layout, port.server.complex)
        bound = parity.wire_step(port.wire, start) * inv_k_lr
        carry = run_and_compare(port, ref, carry,
                                ef_scale_flips=port.ef_store is not None,
                                spread=watch)
        # dc moves by the trained client's own move / (K lr); c by their
        # sum / N (every client of these rounds trains)
        moved = None if watch is None else watch.moved * inv_k_lr
        got, want = port.cv_global, torch.from_numpy(
            np.asarray(ref.cv_global).copy())
        assert_held(got, want, bound + cv_carry,
                    None if moved is None
                    else moved.sum(0) / port.fed.n_devices)
        cv_carry = cv_carry + (got - want).abs()
        rows = port.cv_store.gather(ids)
        ref_rows = torch.from_numpy(ref.cv_store.to_array().copy())
        assert_held(rows, ref_rows, bound + rows_carry, moved)
        assert_norms(port.client_state.column("cv_scale"),
                     ref.client_state.column("cv_scale"), rows, ref_rows)
        rows_carry = rows_carry + (rows - ref_rows).abs()
    assert port.total_bytes == ref.total_bytes


def test_two_scaffold_fedhen_rounds_on_the_int8_wire():
    two_scaffold_fedhen_rounds_on_a_lossy_wire(dict(comm_dtype="int8"))
