"""The dry-runs on ``meta`` tensors (``launch/dryrun.py``,
``launch/fedround_dryrun.py``).

* ``lower_one`` walks gemma2-2b x train_4k, qwen2-moe-a2.7b x decode_32k
  (the MoE router on ``meta``), recurrentgemma-2b x prefill_32k (K5
  and K6 through their ``meta`` paths), gemma2-2b x decode_32k (the
  serve step on a kv_seq-sharded cache), xlstm-1.3b x decode_32k (its
  cache's C, n and conv split over model) and musicgen-large x decode_32k
  (its codebook tables over model) on the single-pod mesh shape; its
  ``param_bytes_per_chip`` and ``cache_bytes_per_chip`` equal the
  reference's ``bytes_per_chip`` of the same trees on the same specs;
  each is walked as one rank of a fake 16 x 16 mesh (its collective bytes
  and term; qwen2-moe's 60 experts do not divide 16, so its experts are
  sharded on expert_ffn and its decode gathers the batch over data for
  its one routing group);
* ``fedround_dryrun.make_round_step`` passes ``tests/test_fedround.py``'s
  ``test_round_step_tiny`` assertions, ported; ``fedround_dryrun.run``
  reports the reference's cohort size and one rank's share, and the
  all-reduce's exact bytes, on a reduced config.
"""

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro import configs as ref_configs  # noqa: E402
from repro.launch import sharding as ref_sharding  # noqa: E402
from repro.models import transformer as ref_tfm  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import (INPUT_SHAPES, LayerSpec,  # noqa: E402
                                      ModelConfig)
from repro_torch.launch import dryrun, fedround_dryrun  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.common import NO_POLICY  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

COMBOS = (("gemma2-2b", "train_4k"), ("qwen2-moe-a2.7b", "decode_32k"),
          ("recurrentgemma-2b", "prefill_32k"), ("gemma2-2b", "decode_32k"),
          ("xlstm-1.3b", "decode_32k"), ("musicgen-large", "decode_32k"))
# the combinations walked as one rank of a live mesh (in scope over a
# model axis)
PER_CHIP = ("gemma2-2b", "recurrentgemma-2b", "qwen2-moe-a2.7b",
            "xlstm-1.3b", "musicgen-large")
# the kernels each combination's step reaches
KERNELS = {"train_4k": set(), "decode_32k": set(),
           "prefill_32k": {"flash_attention", "lru_scan_gated"}}


def ref_bytes(arch, shape):
    cfg = ref_configs.get_config(arch)
    mesh = AbstractMesh((16, 16), ("data", "model"))
    params = jax.eval_shape(lambda k: ref_tfm.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    p = ref_sharding.bytes_per_chip(
        params, ref_sharding.param_specs(params, cfg, mesh), mesh)
    if shape.kind == "train":
        return p, 0
    cache = jax.eval_shape(lambda: ref_tfm.init_cache(
        cfg, shape.global_batch, shape.seq_len))
    return p, ref_sharding.bytes_per_chip(
        cache, ref_sharding.cache_specs(cache, cfg, mesh), mesh)


@pytest.mark.parametrize("combo", COMBOS, ids="x".join)
def test_lower_one_on_meta(combo):
    arch, shape_name = combo
    shape = INPUT_SHAPES[shape_name]
    rec = dryrun.lower_one(arch, shape, multi_pod=False, verbose=False)
    assert (rec["param_bytes_per_chip"], rec["cache_bytes_per_chip"]) == \
        ref_bytes(arch, ref_configs.INPUT_SHAPES[shape_name])
    assert rec["mesh"] == "16x16" and rec["chips"] == 256
    assert rec["flops_per_chip"] > 0 and rec["bytes_per_chip"] > 0
    assert rec["peak_memory_per_chip"] > rec["param_bytes_per_chip"]
    assert set(rec["coll_breakdown"]["kernels"]) == KERNELS[shape_name]
    if arch in PER_CHIP:
        # walked as one rank of a fake 16 x 16 mesh: its collectives'
        # result bytes, and the collective term in the bottleneck
        assert rec["coll_bytes_per_chip"] > 0 and rec["t_collective"] > 0
        assert rec["coll_breakdown"]["counts"]["all-reduce"] > 0
        assert rec["bottleneck"] in ("compute", "memory", "collective")
        assert rec["notes"]["coll_bytes_per_chip"].startswith(
            "the collectives")
        return
    assert rec["coll_bytes_per_chip"] is None and rec["t_collective"] is None
    assert rec["bottleneck"] in ("compute", "memory")
    assert rec["notes"]["coll_bytes_per_chip"].startswith("None")


TINY = ModelConfig(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
                   vocab_size=64, pattern=(LayerSpec("attn"),),
                   exit_layer=1, compute_dtype="float32")


def test_round_step_tiny():
    """``tests/test_fedround.py::test_round_step_tiny`` on the port."""
    k_clients, batch, steps, seq = 4, 2, 2, 16
    step = fedround_dryrun.make_round_step(TINY, NO_POLICY,
                                           local_steps=steps)
    params = tfm.init_params(torch.Generator().manual_seed(0), TINY)
    cohort = tree_map(lambda x: x[None].expand((k_clients,) + x.shape),
                      params)
    data = torch.as_tensor(np.random.default_rng(1).integers(
        0, 64, size=(k_clients, batch, steps, seq + 1)).astype(np.int32))
    is_simple = torch.tensor([True, True, False, False])
    new_complex, loss = step(cohort, data, is_simple)
    assert np.isfinite(float(loss))
    for x in tree_leaves(new_complex):
        assert torch.isfinite(x.float()).all()
    assert any(float((a.float() - b.float()).abs().max()) > 0
               for a, b in zip(tree_leaves(new_complex),
                               tree_leaves(params)))


@pytest.mark.parametrize("chunk", [0, 32])
def test_fedround_dryrun_on_meta(chunk):
    cfg = configs.get_reduced("gemma2-2b")
    r = fedround_dryrun.run(cfg=cfg, local_steps=1, cohort_chunk=chunk,
                            seq=32, batch=2)
    # the reference's K: the data size, or 4x it rounded to lcm(chunk, 16)
    assert r["k_clients"] == (16 if chunk == 0 else 64)
    assert fedround_dryrun.cohort_size(16, 3) == 96
    # rank 0's Shard(0) share of each chunk: 1 of 16; 2 of 32 (2 chunks)
    assert (r["rank_clients"], r["rank_chunk"]) == \
        ((1, 1) if chunk == 0 else (4, 2))
    # the all-reduce: the flat f32 accumulator, two weight totals and the
    # loss sum
    assert r["collective_bytes"] == 4 * r["n_flat"] + 3 * 4
    assert r["flops"] > 0 and r["kernels"]["masked_agg_acc"]["calls"] == \
        r["rank_clients"] // r["rank_chunk"]
