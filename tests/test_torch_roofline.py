"""The port's roofline layer (``repro_torch/roofline``) and the ``meta``
paths it rests on.

* ``analytic_hbm`` and ``model_flops`` equal the reference's for every
  config x input shape, and ``RooflineRecord``'s derived terms equal the
  reference's on the same record at the same constants (the port's are
  the H100's, so the test sets them to the reference's for the
  comparison), to f64 rounding;
* the walk (``torch_walk``) counts 2 m n k for a matmul chain, an
  all-reduce's bytes under gloo at world size 1, and a kernel wrapper's
  reported work on the CPU plain path in place of that path's own ops;
* a telemetry-on LM round (the walk in round 0) is bitwise a
  telemetry-off one;
* ``abstract_params`` matches ``init_params`` leaf for leaf on a reduced
  config, and ``init_cache(device="meta")`` matches ``init_cache``;
* every kernel wrapper returns ``meta`` outputs of its plain version's
  shapes and dtypes, computes nothing and launches nothing.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs several worker processes

from repro import configs as ref_configs  # noqa: E402
from repro.roofline import analysis as ref_analysis  # noqa: E402
from repro.roofline import hw as ref_hw  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES, FedConfig  # noqa: E402
from repro_torch.core.adapters import LMAdapter  # noqa: E402
from repro_torch.core.federated import FederatedTrainer  # noqa: E402
from repro_torch.data.federated import iid_split  # noqa: E402
from repro_torch.data.synthetic import synthetic_lm  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.masked_agg import ops  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as scan_ops  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.obs import telemetry as obslib  # noqa: E402
from repro_torch.roofline import analysis, hw, torch_walk  # noqa: E402
from repro_torch.tree import tree_leaves, tree_leaves_with_keys  # noqa


@pytest.mark.parametrize("arch", list(configs.ARCH_NAMES))
def test_analytic_terms_equal_the_reference(arch):
    cfg, r_cfg = configs.get_config(arch), ref_configs.get_config(arch)
    for name, shape in INPUT_SHAPES.items():
        r_shape = ref_configs.INPUT_SHAPES[name]
        assert analysis.model_flops(cfg, shape) == \
            ref_analysis.model_flops(r_cfg, r_shape)
        for chips in (256, 512):
            for pb, cb in ((1.25e9, 0.0), (3.0e8, 7.5e8)):
                assert analysis.analytic_hbm(cfg, shape, pb, cb, chips) == \
                    ref_analysis.analytic_hbm(r_cfg, r_shape, pb, cb, chips)


def test_h100_constants():
    assert (hw.PEAK_FLOPS_BF16, hw.HBM_BW, hw.NVLINK_BW, hw.HBM_BYTES) == \
        (989.4e12, 3.35e12, 450e9, 80 * 10 ** 9)


@pytest.mark.parametrize("coll", [0.0, 3.0e9])
def test_record_terms_equal_the_reference(monkeypatch, coll):
    """The same record's derived terms in both packages at the
    reference's constants."""
    monkeypatch.setattr(hw, "PEAK_FLOPS_BF16", ref_hw.PEAK_FLOPS_BF16)
    monkeypatch.setattr(hw, "HBM_BW", ref_hw.HBM_BW)
    monkeypatch.setattr(hw, "NVLINK_BW", ref_hw.ICI_LINK_BW)
    fields = dict(arch="a", shape="train_4k", mesh="16x16", chips=256,
                  flops_per_chip=3.7e14, bytes_per_chip=2.2e11,
                  coll_bytes_per_chip=coll, model_flops=6.1e16,
                  hbm_analytic_per_chip=1.9e10)
    mine = analysis.RooflineRecord(**fields)
    theirs = ref_analysis.RooflineRecord(**fields)
    for k in ("t_compute", "t_memory", "t_collective", "bottleneck",
              "useful_flops_ratio", "roofline_time"):
        assert getattr(mine, k) == getattr(theirs, k), k


def test_make_record_from_a_walk():
    cfg = configs.get_config("gemma2-2b")
    shape = INPUT_SHAPES["train_4k"]
    walk = {"flops": 2.56e17, "hbm_bytes": 5.12e14,
            "collective_bytes": {c: 0 for c in torch_walk.COLLECTIVES},
            "collective_counts": {c: 0 for c in torch_walk.COLLECTIVES},
            "total_collective_bytes": 0, "kernels": {}}
    rec = analysis.make_record(arch=cfg.name, shape=shape, mesh_name="16x16",
                               chips=256, walk=walk, cfg=cfg,
                               param_bytes_chip=1.0e9, cache_bytes_chip=0.0,
                               batch_bytes_chip=2.0e6)
    assert rec.flops_per_chip == 1.0e15 and rec.bytes_per_chip == 2.0e12
    assert rec.coll_bytes_per_chip is None and rec.t_collective is None
    assert rec.bottleneck == "compute"
    assert rec.roofline_time == max(rec.t_compute, rec.t_memory)
    assert rec.peak_memory_per_chip == 1.0e9 + 2.0e6
    assert set(rec.notes) == {"flops_per_chip", "bytes_per_chip",
                              "coll_bytes_per_chip", "peak_memory_per_chip"}
    d = rec.to_dict()
    assert d["t_collective"] is None and d["model_flops"] == \
        analysis.model_flops(cfg, shape)


def test_walk_counts_matmul_flops():
    g = torch.Generator().manual_seed(0)
    a, b, c = (torch.randn(s, generator=g) for s in
               ((8, 16), (16, 4), (4, 5)))
    out, w = torch_walk.walk(lambda: torch.relu(a @ b) @ c)
    assert w["flops"] == 2 * 8 * 16 * 4 + 2 * 8 * 4 * 5
    # mm, relu, mm: operands and results, 4 bytes an element
    assert w["hbm_bytes"] == 4 * ((128 + 64 + 32) + (32 + 32)
                                  + (32 + 20 + 40))
    assert torch.equal(out, torch.relu(a @ b) @ c)


def test_walk_counts_all_reduce_bytes():
    import torch.distributed as dist
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.HashStore())
    try:
        x = torch.arange(100, dtype=torch.float32)
        _, w = torch_walk.walk(dist.all_reduce, x)
    finally:
        dist.destroy_process_group()
    assert w["collective_bytes"]["all-reduce"] == 400
    assert w["collective_counts"]["all-reduce"] == 1
    assert w["total_collective_bytes"] == 400
    assert torch.equal(x, torch.arange(100, dtype=torch.float32))


def test_walk_takes_a_wrappers_work_not_its_plain_ops():
    z, n = 3, 1000
    g = torch.Generator().manual_seed(1)
    acc, x = torch.zeros(n), torch.randn((z, n), generator=g)
    mask = torch.rand(n, generator=g) > 0.5
    w = torch.ones(z)
    want = ops.masked_agg_acc_(acc.clone(), x, mask, w, w)
    got, walk = torch_walk.walk(ops.masked_agg_acc_, acc, x, mask, w, w)
    assert torch.equal(got, want)
    nbytes = 2 * 4 * n + 4 * z * n + n + 2 * 4 * z
    assert walk["kernels"] == {"masked_agg_acc": {
        "calls": 1, "flops": 2 * z * n, "bytes": nbytes}}
    assert (walk["flops"], walk["hbm_bytes"]) == (2 * z * n, nbytes)


def _lm_trainer(telemetry):
    cfg = configs.get_reduced("gemma2-2b").with_overrides(
        compute_dtype="float32")
    data = synthetic_lm(16, 16, cfg.vocab_size, seed=0)
    shards = [{"tokens": s["tokens"]} for s in iid_split(data, 4, seed=1)]
    fed = FedConfig(n_devices=4, n_simple=2, participation=1.0,
                    local_epochs=1, batch_size=2, cohort_chunk=2)
    return FederatedTrainer(LMAdapter(cfg), fed, shards, device="cpu",
                            generator=torch.Generator().manual_seed(0),
                            telemetry=telemetry)


def test_walked_lm_round_is_bitwise_the_unwalked_one():
    mem = obslib.MemorySink()
    off, on = _lm_trainer(None), _lm_trainer(obslib.Telemetry([mem]))
    assert [off.run_round() for _ in range(2)] == \
        [on.run_round() for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(off.server.complex), tree_leaves(on.server.complex)))
    roof = mem.named("roofline")
    assert len(roof) == 1 and roof[0]["round"] == 0
    values = roof[0]["values"]
    assert list(values) == ["flops", "hbm_bytes", "collective_bytes"]
    assert values["flops"] > 0 and values["collective_bytes"] == 0
    # the round's two K1 folds are in it
    fold = 2 * (2 * 4 + 2 * 4 + 1) * on.layout.n_flat
    assert values["hbm_bytes"] > fold


def test_abstract_params_and_meta_cache_match_the_real_trees():
    cfg = dataclasses.replace(configs.get_reduced("recurrentgemma-2b"),
                              n_layers=5, exit_layer=2)
    real = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    meta = tfm.abstract_params(cfg)
    pairs = list(zip(tree_leaves_with_keys(real),
                     tree_leaves_with_keys(meta)))
    assert len(pairs) == len(tree_leaves(real))
    for (k1, a), (k2, b) in pairs:
        assert k1 == k2 and b.is_meta
        assert (tuple(a.shape), a.dtype) == (tuple(b.shape), b.dtype), k1
    cache = tfm.init_cache(cfg, 2, 64)
    meta_cache = tfm.init_cache(cfg, 2, 64, device="meta")
    assert [(k, tuple(x.shape), x.dtype)
            for k, x in tree_leaves_with_keys(cache)] == \
        [(k, tuple(x.shape), x.dtype)
         for k, x in tree_leaves_with_keys(meta_cache)]


def _wrapper_cases():
    g = torch.Generator().manual_seed(2)
    z, n, qb, k = 3, 1024, 128, 256
    acc = torch.zeros(n)
    x = torch.randn((z, n), generator=g)
    mask = torch.rand(n, generator=g) > 0.5
    w = torch.ones(z)
    q = torch.randint(-127, 128, (z, n), generator=g, dtype=torch.int8)
    scales = torch.rand((z, n // qb), generator=g)
    idx = torch.stack([torch.sort(torch.randperm(n, generator=g)[:k])[0]
                       for _ in range(z)]).to(torch.int32)
    vals = torch.randn((z, k), generator=g)
    plan_layout = type("Layout", (), {})()
    plan_layout.signature = ("meta-test", n)
    plan_layout.slots = [type("S", (), {"offset": 0, "size": 600})(),
                         type("S", (), {"offset": 640, "size": 384})()]
    b, s, h, kh, dh = 1, 64, 4, 2, 32
    qq = torch.randn((b, s, h, dh), generator=g)
    kk = torch.randn((b, s, kh, dh), generator=g)
    a_ = torch.rand((2, 16, 8), generator=g)
    xs = torch.randn((2, 16, 8), generator=g)
    vec = lambda: torch.randn(8, generator=g)  # noqa: E731
    return {
        "K1": (ops.masked_agg_acc_, (acc, x, mask, w, w), {}),
        "K2": (ops.masked_agg_acc_deq_, (acc, q, scales, mask, w, w),
               {"quant_block": qb}),
        "K3": (ops.masked_scatter_acc_, (acc, vals, None, idx, mask, w, w),
               {"quant_block": qb}),
        "K4 fold": (ops.masked_agg_fold_, (acc, x, mask, w, w),
                    {"plan": lambda dev: ops.fold_plan(plan_layout, dev)}),
        "K4": (ops.masked_agg_, (x, mask, w, w), {}),
        "K5 f32": (fa_ops.flash_attention, (qq, kk, kk), {"window": 16}),
        "K5 bf16": (fa_ops.flash_attention,
                    tuple(t.to(torch.bfloat16) for t in (qq, kk, kk)), {}),
        "K6": (scan_ops.lru_scan, (a_, xs), {}),
        "K6 gated": (scan_ops.lru_scan_gated,
                     (xs, vec(), vec(), vec(), vec(), -vec().abs()), {}),
    }


@pytest.mark.parametrize("name", list(_wrapper_cases()))
def test_every_wrapper_has_a_meta_path(name):
    fn, args, kw = _wrapper_cases()[name]
    on = {dev: {k: v(dev) if callable(v) else v for k, v in kw.items()}
          for dev in ("cpu", "meta")}
    want = fn(*(None if t is None else t.clone() for t in args),
              **on["cpu"])
    meta_args = tuple(None if t is None else t.to("meta") for t in args)
    before = (ops.masked_agg_acc_.launches, ops.masked_agg_fold_.launches,
              fa_ops.flash_attention.launches_tc,
              scan_ops.lru_scan_gated.launches)
    got, walk = torch_walk.walk(fn, *meta_args, **on["meta"])
    assert got.is_meta
    assert (tuple(got.shape), got.dtype) == (tuple(want.shape), want.dtype)
    if name.startswith(("K1", "K2", "K3", "K4 fold")):
        assert got is meta_args[0]            # in place, as on the CPU
    assert before == (ops.masked_agg_acc_.launches,
                      ops.masked_agg_fold_.launches,
                      fa_ops.flash_attention.launches_tc,
                      scan_ops.lru_scan_gated.launches)
    (kernel, work), = walk["kernels"].items()
    assert work["calls"] == 1 and work["bytes"] > 0 and work["flops"] > 0
    assert (walk["flops"], walk["hbm_bytes"]) == (work["flops"],
                                                  work["bytes"])
