"""Port parity of the input-shape catalogue and ``resnet.subnet_mask``:
``configs.input_specs`` for every arch and every ``INPUT_SHAPES`` entry
(shapes and dtypes equal to the reference's ``ShapeDtypeStruct``s, every
tensor on the ``meta`` device), the shapes themselves,
``NATIVE_LONGCTX`` and ``needs_longctx_variant``, and the ResNet's index
set M.
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro.configs import base as ref_base  # noqa: E402
from repro.models import resnet as ref_resnet  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.models import resnet  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


def test_input_shapes_equal_the_reference():
    assert list(base.INPUT_SHAPES) == list(ref_base.INPUT_SHAPES)
    for name, shape in base.INPUT_SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            ref_base.INPUT_SHAPES[name])
    assert configs.INPUT_SHAPES is base.INPUT_SHAPES
    assert configs.NATIVE_LONGCTX == ref_configs.NATIVE_LONGCTX


@pytest.mark.parametrize("shape", list(ref_base.INPUT_SHAPES))
@pytest.mark.parametrize("arch", ref_configs.ARCH_NAMES)
def test_input_specs_equal_the_reference(arch, shape):
    want = ref_configs.input_specs(ref_configs.get_config(arch),
                                   ref_base.INPUT_SHAPES[shape])
    got = configs.input_specs(configs.get_config(arch),
                              base.INPUT_SHAPES[shape])
    assert list(got) == list(want)
    for key, spec in want.items():
        assert isinstance(spec, jax.ShapeDtypeStruct)
        assert got[key].device.type == "meta"
        assert tuple(got[key].shape) == spec.shape
        assert str(got[key].dtype).replace("torch.", "") == str(spec.dtype)
    # needs_longctx_variant agrees on every (arch, shape)
    assert configs.needs_longctx_variant(
        configs.get_config(arch), base.INPUT_SHAPES[shape]) == \
        ref_configs.needs_longctx_variant(ref_configs.get_config(arch),
                                          ref_base.INPUT_SHAPES[shape])


@pytest.mark.parametrize("arch", ["llava-next-34b", "musicgen-large"])
def test_input_specs_batch_override(arch):
    shape = base.INPUT_SHAPES["train_4k"]
    want = ref_configs.input_specs(ref_configs.get_config(arch),
                                   ref_base.INPUT_SHAPES["train_4k"], 3)
    got = configs.input_specs(configs.get_config(arch), shape, 3)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}


def test_resnet_subnet_mask_equals_the_reference():
    want = ref_resnet.subnet_mask(
        jax.eval_shape(ref_resnet.init_params, jax.random.PRNGKey(0)))
    params = resnet.init_params(torch.Generator().manual_seed(0),
                                channels=(8, 16, 16, 16))
    got = resnet.subnet_mask(params)
    assert got.keys() == want.keys()
    for key in got:
        g, w = tree_leaves(got[key]), jax.tree.leaves(want[key])
        assert len(g) == len(w)
        assert g == [bool(x) for x in w]
        assert all(x is (key in ("stem", "stage1", "stage2", "exit_head"))
                   for x in g)
    assert np.sum([len(tree_leaves(v)) for v in got.values()]) == \
        len(tree_leaves(params))
