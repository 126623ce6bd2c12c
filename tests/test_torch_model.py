"""Port parity of the model, its losses and gradients, and the optimizer.

Narrow PreActResNet18-GN trees (every width is read from the params) on
2 images of 16x16, the same weights in both packages (``interop``).  At
8x8 the last stage normalizes groups of 2 values, where the gradient is
ill-conditioned enough that f32 rounding alone exceeds 1e-5.
Tolerance rtol = atol = 1e-5 for activations, losses and gradients (two
frameworks' f32 convolutions and reductions sum in different orders);
rtol 1e-6 for the optimizer's elementwise arithmetic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro.core.adapters import ResNetAdapter as RefAdapter  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro.models import resnet as ref_resnet  # noqa: E402
from repro.optim import sgd as ref_sgd  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.core.adapters import ResNetAdapter  # noqa: E402
from repro_torch.models import common, resnet  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.tree import tree_flatten, tree_leaves, \
    tree_unflatten  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
NARROW = (8, 16, 16, 16)


def _setup(seed=0, b=2, size=16):
    params = resnet.init_params(torch.Generator().manual_seed(seed), 10,
                                NARROW)
    ref_params = jax.tree.map(jnp.asarray, interop.to_reference(params))
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(b, size, size, 3)).astype(np.float32)
    labels = rng.integers(0, 10, size=b).astype(np.int32)
    batch = {"images": torch.from_numpy(images),
             "labels": torch.from_numpy(labels)}
    ref_batch = {"images": jnp.asarray(images), "labels": jnp.asarray(labels)}
    return params, ref_params, batch, ref_batch


@pytest.mark.parametrize("c", [6, 8, 12, 16])
def test_groupnorm_matches_reference(c):
    rng = np.random.default_rng(c)
    x = rng.normal(2.0, 3.0, size=(2, 5, 4, c)).astype(np.float32)
    p = {"scale": rng.normal(size=c).astype(np.float32),
         "bias": rng.normal(size=c).astype(np.float32)}
    want = ref_common.apply_groupnorm(jax.tree.map(jnp.asarray, p),
                                      jnp.asarray(x))
    got = common.apply_groupnorm(interop.from_reference(p),
                                 torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), **TOL)


@pytest.mark.parametrize("size,stride", [(8, 1), (8, 2), (7, 2), (16, 2)])
@pytest.mark.parametrize("k", [1, 3])
def test_same_padding_conv_matches_xla(size, stride, k):
    rng = np.random.default_rng(size * 10 + stride + k)
    x = rng.normal(size=(2, size, size, 4)).astype(np.float32)
    w = rng.normal(size=(k, k, 4, 6)).astype(np.float32)
    want = ref_resnet.conv2d(jnp.asarray(x), jnp.asarray(w), stride)
    got = resnet.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                        torch.from_numpy(w), stride)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), **TOL)


def test_forward_and_forward_simple_match_reference():
    params, ref_params, batch, ref_batch = _setup()
    exit_l, final_l = resnet.forward(params, batch["images"])
    ref_exit, ref_final = ref_resnet.forward(ref_params, ref_batch["images"])
    np.testing.assert_allclose(exit_l.numpy(), np.asarray(ref_exit), **TOL)
    np.testing.assert_allclose(final_l.numpy(), np.asarray(ref_final), **TOL)
    simple = resnet.forward_simple(params, batch["images"])
    np.testing.assert_allclose(
        simple.numpy(),
        np.asarray(ref_resnet.forward_simple(ref_params,
                                             ref_batch["images"])), **TOL)


def test_softmax_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 4, size=(6, 10)).astype(np.float32)
    labels = rng.integers(0, 10, size=6).astype(np.int32)
    np.testing.assert_allclose(
        float(common.softmax_cross_entropy(torch.from_numpy(logits),
                                           torch.from_numpy(labels))),
        float(ref_common.softmax_cross_entropy(jnp.asarray(logits),
                                               jnp.asarray(labels))),
        **TOL)


@pytest.mark.parametrize("loss", ["loss_simple", "loss_complex",
                                  "loss_side"])
def test_losses_and_grads_match_jax_grad(loss):
    params, ref_params, batch, ref_batch = _setup(seed=1)
    leaves, treedef = tree_flatten(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    adapter, ref_adapter = ResNetAdapter(10, NARROW), RefAdapter(10)
    value = getattr(adapter, loss)(params, batch)
    grads = torch.autograd.grad(value, leaves, allow_unused=True)
    ref_value, ref_grads = jax.value_and_grad(getattr(ref_adapter, loss))(
        ref_params, ref_batch)
    np.testing.assert_allclose(value.item(), float(ref_value), **TOL)
    for g, rg in zip(grads, jax.tree.leaves(ref_grads)):
        if g is None:
            # a parameter the loss never touches (outside M for the
            # simple loss, the exit head for the complex one): JAX's
            # gradient is exactly zero there
            assert loss != "loss_side"
            assert float(jnp.max(jnp.abs(rg))) == 0.0
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(rg), **TOL)


def test_evaluate_matches_reference():
    params, ref_params, _, _ = _setup(seed=2)
    rng = np.random.default_rng(5)
    images = rng.normal(size=(16, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, 10, size=16).astype(np.int32)
    got = ResNetAdapter(10, NARROW).evaluate(
        params, {"images": torch.from_numpy(images),
                 "labels": torch.from_numpy(labels)})
    want = RefAdapter(10).evaluate(ref_params,
                                   {"images": jnp.asarray(images),
                                    "labels": jnp.asarray(labels)})
    assert {k: float(v) for k, v in got.items()} == \
        {k: float(v) for k, v in want.items()}


def _grad_trees(seed):
    rng = np.random.default_rng(seed)

    def tree():
        mk = lambda *s: rng.normal(0, 4, size=s).astype(np.float32)
        return {"a": mk(3, 4), "b": [mk(5), mk(2, 2)], "c": mk()}

    return tree(), tree()


@pytest.mark.parametrize("clip", [None, 10.0, 0.5])
def test_sgd_with_missing_grads_matches_reference(clip):
    params, grads = _grad_trees(0)
    # JAX returns zeros where PyTorch returns None
    tgrads = interop.from_reference(grads)
    tgrads["b"][0] = None
    grads["b"][0] = np.zeros_like(grads["b"][0])
    tparams = interop.from_reference(params)
    got = sgd.sgd_update(tparams, tgrads, 0.1, clip)
    want = ref_sgd.sgd_update(jax.tree.map(jnp.asarray, params),
                              jax.tree.map(jnp.asarray, grads), 0.1, clip)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    assert got["b"][0] is tparams["b"][0]      # untouched, unchanged
    norm = sgd.global_norm(tgrads)
    np.testing.assert_allclose(
        float(norm), float(ref_sgd.global_norm(
            jax.tree.map(jnp.asarray, grads))), rtol=1e-6)
    clipped, _ = sgd.clip_by_global_norm(tgrads, 0.5)
    ref_clipped, _ = ref_sgd.clip_by_global_norm(
        jax.tree.map(jnp.asarray, grads), 0.5)
    for a, b in zip(tree_leaves(clipped), jax.tree.leaves(ref_clipped)):
        if a is None:
            assert float(jnp.max(jnp.abs(b))) == 0.0
            continue
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_tree_order_is_jax_order():
    tree = {"z": [1, {"b": 2, "a": 3}], "a": (4, 5), "m": 6}
    leaves, treedef = tree_flatten(tree)
    assert leaves == jax.tree.leaves(tree)
    assert tree_unflatten(treedef, leaves) == \
        {"a": (4, 5), "m": 6, "z": [1, {"a": 3, "b": 2}]}
