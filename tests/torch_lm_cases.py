"""Decoder configurations and same-start weights shared by the port's LM
parity tests (``tests/test_torch_lm_*.py``, ``test_torch_round_lm.py``).

Each case is one ``ModelConfig`` built in both packages from the same
fields: the reduced gemma2-2b and recurrentgemma-2b (the exit at their
last layer), the same deepened to two periods, a remainder layer and an
exit inside the stack (so M cuts the stacked leaves), and ``attn4``, the
attention-only config every committed BENCH row trains
(``benchmarks/fed_common.py``'s ``BENCH_CFG``).  Weights are drawn by
the reference and carried across with ``interop``.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import numpy as np
import torch

from repro import configs as ref_configs
from repro.models import transformer as ref_tfm

from repro_torch import configs, interop
from repro_torch.configs import base
from repro_torch.tree import tree_leaves

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from benchmarks.fed_common import BENCH_CFG  # noqa: E402

# name -> (arch or None for attn4, overrides)
CASES = {
    "gemma2-2b": ("gemma2-2b", {}),
    "gemma2-2b-deep": ("gemma2-2b", dict(n_layers=5, exit_layer=2)),
    "recurrentgemma-2b": ("recurrentgemma-2b", {}),
    "recurrentgemma-2b-deep": ("recurrentgemma-2b",
                               dict(n_layers=7, exit_layer=3)),
    "attn4": (None, {}),
}

def _port_copy(ref_cfg):
    """The port's ModelConfig with every field of ``ref_cfg``."""
    fields = {f.name: getattr(ref_cfg, f.name)
              for f in dataclasses.fields(ref_cfg)}
    fields["pattern"] = tuple(base.LayerSpec(s.mixer, s.mlp)
                              for s in ref_cfg.pattern)
    return base.ModelConfig(**fields)

def config_pair(name):
    """(reference config, port config) of case ``name``."""
    arch, over = CASES[name]
    if arch is None:
        ref_cfg = BENCH_CFG
        return ref_cfg, _port_copy(ref_cfg)
    ref_cfg = ref_configs.get_reduced(arch).with_overrides(**over)
    port_cfg = configs.get_reduced(arch).with_overrides(**over)
    return ref_cfg, port_cfg

def params_pair(ref_cfg, seed=0):
    """(reference params, the port's copy of them)."""
    ref_p = ref_tfm.init_params(jax.random.PRNGKey(seed), ref_cfg)
    return ref_p, interop.from_reference(jax.tree.map(np.asarray, ref_p))

def tokens(n, s, vocab, seed=0):
    """(n, s + 1) int32 token rows."""
    return np.random.default_rng(seed).integers(
        0, vocab, size=(n, s + 1)).astype(np.int32)


def port_grads(loss_fn, params, batch):
    """(loss, grads) of the port's ``loss_fn`` at ``params``, in leaf
    order, a ``None`` gradient as zeros."""
    leaves = tree_leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    loss = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for x in leaves:
        x.requires_grad_(False)
    return loss.detach(), [torch.zeros_like(x) if g is None else g
                           for g, x in zip(grads, leaves)]
