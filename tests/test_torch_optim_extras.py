"""Port parity of ``optim/sgd.py``'s AdamW and cosine schedule, which no
module of either package calls: ten AdamW steps on the same numpy-seeded
params and gradients, with and without weight decay and clipping, on f32
and bf16 params (the moments f32 in both), at rtol 1e-6 / atol 1e-7; the
schedule at every step from 0 to total + 2 at rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.optim import sgd as ref_sgd  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

import jax  # noqa: E402

RTOL, ATOL = 1e-6, 1e-7


def _tree(rng, dtype):
    leaf = lambda *s: rng.normal(size=s).astype(np.float32)
    tree = {"w": leaf(8, 5), "b": leaf(5), "blocks": [leaf(3, 4), leaf(7)]}
    return jax.tree.map(lambda x: np.asarray(jnp.asarray(x, dtype)), tree)


def _close(got, want):
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert a.dtype == interop.from_reference(np.asarray(b)).dtype
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weight_decay,clip_norm",
                         [(0.0, None), (0.01, None), (0.0, 1.0),
                          (0.05, 0.5)])
def test_adam_ten_steps_match_reference(dtype, weight_decay, clip_norm):
    rng = np.random.default_rng(3)
    params = _tree(rng, jnp.dtype(dtype))
    ref_p, ref_state = params, ref_sgd.adam_init(params)
    p = interop.from_reference(params)
    state = sgd.adam_init(p)
    for leaf in tree_leaves(state.mu) + tree_leaves(state.nu):
        assert leaf.dtype == torch.float32
    for _ in range(10):
        grads = _tree(rng, jnp.dtype(dtype))
        ref_p, ref_state = ref_sgd.adam_update(
            ref_p, grads, ref_state, 1e-2, weight_decay=weight_decay,
            clip_norm=clip_norm)
        p, state = sgd.adam_update(
            p, interop.from_reference(grads), state, 1e-2,
            weight_decay=weight_decay, clip_norm=clip_norm)
    assert int(state.step) == int(ref_state.step) == 10
    assert state.step.dtype == torch.int32
    _close(p, ref_p)
    _close(state.mu, ref_state.mu)
    _close(state.nu, ref_state.nu)


def test_adam_reads_a_none_gradient_as_zero():
    rng = np.random.default_rng(4)
    params = _tree(rng, jnp.float32)
    grads = _tree(rng, jnp.float32)
    zero = dict(grads, b=np.zeros_like(grads["b"]))
    want, _ = ref_sgd.adam_update(params, zero, ref_sgd.adam_init(params),
                                  1e-2)
    p = interop.from_reference(params)
    g = dict(interop.from_reference(grads), b=None)
    got, _ = sgd.adam_update(p, g, sgd.adam_init(p), 1e-2)
    _close(got, want)


@pytest.mark.parametrize("base_lr,warmup,total",
                         [(0.1, 5, 40), (3e-4, 0, 17), (1.0, 10, 10)])
def test_cosine_schedule_matches_reference(base_lr, warmup, total):
    ref_lr = ref_sgd.cosine_schedule(base_lr, warmup, total)
    lr = sgd.cosine_schedule(base_lr, warmup, total)
    for step in range(total + 3):
        got = lr(step)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), float(ref_lr(step)),
                                   rtol=1e-6)
