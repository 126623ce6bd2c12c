"""Port parity of whole rounds on the lossy wires: one fedhen round on
the bf16 and int8 wires here; noside, decouple and the compressed wire in
``test_torch_round_wire_{noside,decouple,decouple_bf16,v2}.py``, which
share this file's rules (each file stays under 50 s: a reference round's
jit takes 12-30 s to compile on the CPU).

Setup as in ``test_torch_round.py``: narrow PreActResNet18-GN on 16x16
synthetic CIFAR, 4 clients (2 simple + 2 complex), the same start weights.
The port's trained parameters differ from the reference's by about 1e-6,
and on a lossy wire that now and then flips a rounding, which moves the
element by about one quantization step.  So the server params (and the
EF rows) are held to the rules of ``repro_torch.parity``: at most
``MAX_SHARE`` of the elements outside rtol 1e-4, atol 1e-5 (measured on
these rounds: at most 8.1e-5), and every element within that tolerance
plus the steps one flip can take there (plus, in a second round, the
first round's difference).  Losses atol 1e-5, ``n_valid`` and the
measured bytes exactly.

Clients take one or two SGD steps a round.  With four steps at lr 0.1 the
two packages' trained clients can come apart by up to 1.5e-2 relative in
a gradient: f32 rounding pushes a stage-2 ReLU input that lies within
1e-7 of zero to the other side, and the reference's own jitted and eager
programs disagree there by as much (``test_torch_int8_sensitivity.py``
pins it down).  No wire rule covers a kink, so these rounds stay short.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro_torch import interop, parity  # noqa: E402
from repro_torch.core import flatten  # noqa: E402
from test_torch_round import ROUND, make_pair, make_shards  # noqa: E402

MAX_SHARE = 1e-3


class ReferenceBits:
    """The reference trainer's stochastic-rounding bits, recomputed: the
    client's training key (as ``ReferenceSchedule`` derives it) folded with
    the wire tag, then ``jax.random.bits`` of the shape asked for."""

    def __init__(self, seed: int):
        self.seed = seed

    def __call__(self, round_index, population, slot, shape):
        key = jax.random.PRNGKey(self.seed * 100003 + round_index)
        rs, rc = jax.random.split(key)
        client = jax.random.fold_in(rs if population == "simple" else rc,
                                    slot)
        drawn = jax.random.bits(jax.random.fold_in(client, 0x57495245),
                                tuple(shape), jnp.uint32)
        return torch.from_numpy(np.asarray(drawn).astype(np.int64))


def _flat(layout, tree):
    if not isinstance(jax.tree.leaves(tree)[0], torch.Tensor):
        tree = interop.from_reference(jax.tree.map(np.asarray, tree))
    return flatten.pack(layout, tree)


def _models(trainer):
    server = trainer.server
    return [m for m in (server.complex, server.simple_host) if m is not None]


def assert_held(a, b, step, moved=None):
    """Hold ``a`` to ``b`` under the lossy-wire rules (at most
    ``MAX_SHARE`` of the elements outside the float tolerance, every
    element within it plus ``step``).  ``moved``: how far the reference
    itself moves at each element when its clients train from the port's
    inputs instead of its own (``ReferenceSpread`` in
    ``test_torch_scaffold_wire.py``).  It is added to the step, and the
    share of elements it alone puts outside the tolerance to the share
    allowed.  Returns :func:`parity.lossy_compare`'s result."""
    if moved is None:
        res = parity.lossy_compare(a, b, step)
        assert res["share"] <= MAX_SHARE and res["worst"] <= 1.0, res
        return res
    res = parity.lossy_compare(a, b, step + moved)
    own = float(parity.outside(b + moved, b).float().mean())
    assert res["share"] <= MAX_SHARE + own and res["worst"] <= 1.0, \
        (res, own)
    return res


def assert_norms(scale, ref_scale, rows, ref_rows):
    """Each row's norm (a client-state column) within rtol 1e-5 of the
    reference's, plus the norm of the row's difference at the elements
    rule 1 counts as outside the tolerance (``|(|a| - |b|)| <= |a - b|``):
    a flip the rules allow in a row is allowed in its norm, and nothing
    more."""
    flipped = parity.outside(rows, ref_rows)
    moved = torch.linalg.vector_norm(
        torch.where(flipped, rows - ref_rows, 0.0).double(), dim=1).numpy()
    assert (np.abs(scale - ref_scale)
            <= 1e-5 * np.abs(ref_scale) + moved).all(), \
        (scale, ref_scale, moved)


def run_and_compare(port, ref, carry, *, ef_scale_flips=False, spread=None):
    """One round of each trainer, held to the lossy-wire rules; returns
    the new carry (the elementwise differences, added to the next
    round's bound).  Each client's ``ef_scale`` (its EF row's norm) is
    held at rtol 1e-5, or with ``ef_scale_flips`` by
    :func:`assert_norms`, for rounds whose EF rows may flip.  ``spread``
    (a ``ReferenceSpread``) watches the port's round and gives each
    client's ``moved`` to :func:`assert_held`."""
    layout = port.layout
    starts = [_flat(layout, m) for m in _models(port)]
    uploads = parity.UploadSteps()
    watch = spread.round() if spread is not None else contextlib.nullcontext()
    with uploads(), watch:
        got = port.run_round()
    want = ref.run_round()
    for key in ("loss_simple", "loss_complex"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5)
    assert got["n_valid"] == want["n_valid"]
    assert (port.bytes_down_per_round, port.bytes_up_per_round) == \
        (ref.bytes_down_per_round, ref.bytes_up_per_round)
    assert port.total_bytes == ref.total_bytes
    ends = [_flat(layout, m) for m in _models(ref)]
    step = torch.stack([parity.round_step(port.wire, s, e, uploads)
                        for s, e in zip(starts, ends)]).amax(0)
    moved = spread.moved if spread is not None else None
    new_carry = []
    for mine, theirs, c in zip(_models(port), ends, carry):
        assert_held(_flat(layout, mine), theirs, step + c,
                    None if moved is None else moved.amax(0))
        new_carry.append(c + (_flat(layout, mine) - theirs).abs())
    if port.ef_store is not None:
        ids = np.arange(port.fed.n_devices)
        rows = port.ef_store.gather(ids)
        ref_rows = torch.from_numpy(ref.ef_store.to_array().copy())
        assert_held(rows, ref_rows, (step + carry[0]).expand(len(ids), -1),
                    moved)
        for col in ("participation", "last_round"):
            np.testing.assert_array_equal(port.client_state.column(col),
                                          ref.client_state.column(col))
        scale = port.client_state.column("ef_scale")
        ref_scale = ref.client_state.column("ef_scale")
        if ef_scale_flips:
            assert_norms(scale, ref_scale, rows, ref_rows)
        else:
            np.testing.assert_allclose(scale, ref_scale, rtol=1e-5)
    return new_carry


def one_round_on_a_lossy_wire(algorithm, wire):
    port, ref = make_pair(make_shards(), algorithm=algorithm,
                          comm_dtype=wire, **ROUND)
    run_and_compare(port, ref, [torch.zeros(port.layout.n_flat)] * 2)


@pytest.mark.parametrize("wire", ["bfloat16", "int8"])
def test_one_fedhen_round_on_a_lossy_wire_matches_reference(wire):
    one_round_on_a_lossy_wire("fedhen", wire)
