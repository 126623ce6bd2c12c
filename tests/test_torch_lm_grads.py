"""Port parity of ``LMAdapter``'s three losses and their gradients.

``loss_complex``, ``loss_simple`` and ``loss_side`` of the reference under
``jax.grad`` against the port's under ``torch.autograd.grad``, on the same
weights (drawn by the reference, carried with ``interop``) and seeded
numpy tokens, at the deepened reduced configs and ``attn4``
(``torch_lm_cases``), where M cuts the stacked leaves.  A gradient the
port leaves ``None`` (a leaf the loss never touches) is compared as
zeros, which is what JAX returns.  f32, rtol 1e-4 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro.core.adapters import LMAdapter as RefLMAdapter  # noqa: E402

from torch_lm_cases import config_pair, params_pair, port_grads  # noqa
from torch_lm_cases import tokens  # noqa: E402

from repro_torch.core.adapters import LMAdapter  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
S = 16
DEEP = ("gemma2-2b-deep", "recurrentgemma-2b-deep", "attn4")


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("loss", ["loss_complex", "loss_simple",
                                  "loss_side"])
@pytest.mark.parametrize("case", DEEP)
def test_loss_gradients_match_jax_grad(case, loss):
    ref_cfg, cfg = config_pair(case)
    ref_p, p = params_pair(ref_cfg, seed=3)
    tok = tokens(2, S, cfg.vocab_size, seed=4)
    ref_loss = getattr(RefLMAdapter(ref_cfg), loss)
    want, want_g = jax.jit(jax.value_and_grad(ref_loss))(
        ref_p, {"tokens": jnp.asarray(tok)})
    got, got_g = port_grads(getattr(LMAdapter(cfg), loss), p,
                            {"tokens": torch.from_numpy(tok)})
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    for g, w in zip(got_g, jax.tree.leaves(want_g)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), _np(w), **TOL)
