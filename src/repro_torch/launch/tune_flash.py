"""K5's f32 kernel against other builds of it, timed in turns on the card.

The built library's f32 kernel (``csrc/flash_attention.cu`` through
``ops.flash_attention``) and each ``--baseline`` (a ``.cu`` file with the
same C entry, or the ``flash_attention/csrc`` directory of another
checkout, e.g. a ``git archive`` of the parent commit, whose
``flash_attention.cu`` is taken; each built alone by nvcc with the port's
flags), held against the plain version (``ref.flash_attention_ref``) at
rtol = atol = 1e-5 with max|diff| printed, then timed in turns (built,
each baseline, each baseline, built) on ``chip_smoke.time_ms`` beside SDPA
in f32, at the f32 shapes ``chip_smoke.py`` times (recurrentgemma-2b's
prefill shape and gemma2-2b's global layer) and untimed edge cases.  Each
time has its TFLOP/s and its share of the bound at the f32 CUDA-core peak
(67 TFLOP/s) and at split TF32's (495 / 3 = 165 TFLOP/s of f32 products).
``--probe`` instead prints, for every build, max|diff| with the operands
as drawn and made exact in TF32 (``variants/flash_attention_tf32.cu``,
the split-TF32 kernel this one's design was measured against, is the
build that probe is for).  A baseline that is a ``csrc`` directory builds
both K5 kernels (``flash_attention_wgmma.cu`` too), and every shape
``chip_smoke.py`` checks (``FLASH_CASES``, ``TP_FLASH_CASES``) is added
untimed; each row records, for each baseline, whether the built library's
call (``ops.flash_attention``: whole sequences, q_offset 0) is bitwise
that build's (``{name}_bitwise``).  Needs a card and nvcc; run from the
root of a checkout:

    python -m repro_torch.launch.tune_flash [--baseline PATH ...] [--probe]
        [--out FILE]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops, ref

# (label, B, S, H, Kh, Dh, window, softcap, dtype, timed): chip_smoke's
# layout
CASES = (("recurrentgemma-2b shape in f32", 4, 4096, 10, 1, 256, 2048, 0.0,
          "float32", True),
         ("gemma2-2b global in f32", 1, 8192, 8, 4, 256, 0, 50.0, "float32",
          True),
         ("G 3, ragged S", 2, 1000, 6, 2, 64, 0, 0.0, "float32", False),
         ("G 130", 1, 70, 130, 1, 256, 0, 0.0, "float32", False),
         ("window under a tile, softcap", 2, 700, 8, 4, 256, 9, 30.0,
          "float32", False),
         ("Dh 32", 2, 190, 4, 1, 32, 0, 0.0, "float32", False),
         ("Dh 128, softcap and window", 2, 517, 4, 2, 128, 200, 30.0,
          "float32", False))
# rtol = atol against the plain version, by dtype (check_flash's rules)
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
# (label, B, S, H, Kh, Dh, window, softcap): shapes at which --probe holds
# the kernel to the plain version with operands made exact in TF32
PROBES = (("window 9, softcap 30", 2, 700, 8, 4, 256, 9, 30.0),
          ("recurrentgemma-2b, S 2048", 1, 2048, 10, 1, 256, 2048, 0.0),
          ("G 130", 1, 70, 130, 1, 256, 0, 0.0))


def tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero: cvt.rna's rounding), kept as f32."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def probe(case, baselines) -> dict:
    """max|diff| of the kernel against the plain version with q, k, v as
    drawn, and with Q and K, V, or all three rounded to TF32 first (an
    exact operand has lo = 0, so its lo products drop out), and with the
    scores 16 times smaller: where the error lives."""
    label, b, s, h, kh, dh, window, cap = case
    g = torch.Generator(device="cuda").manual_seed(s + h)
    q = torch.randn((b, s, h, dh), generator=g, device="cuda") * 2
    k = torch.randn((b, s, kh, dh), generator=g, device="cuda") * 2
    v = torch.randn((b, s, kh, dh), generator=g, device="cuda")
    row = {"probe": label}
    for name, (qq, kk, vv) in (
            ("as drawn", (q, k, v)), ("q, k in tf32", (tf32(q), tf32(k), v)),
            ("v in tf32", (q, k, tf32(v))),
            ("q, k, v in tf32", (tf32(q), tf32(k), tf32(v))),
            ("q / 16", (q / 16, k, v))):
        want = ref.flash_attention_ref(qq, kk, vv, window=window,
                                       softcap=cap)
        got = {"built": ops.flash_attention(qq, kk, vv, window=window,
                                            softcap=cap)}
        for bname, lib in baselines.items():
            got[bname] = baseline_call(lib, qq, kk, vv, window, cap)
        row[name] = {n: float((x - want).abs().max()) for n, x in
                     got.items()}
    print("  " + json.dumps(row), flush=True)
    return row


def compile_baseline(path: Path, work: Path) -> ctypes.CDLL:
    """``path`` as a library with K5's whole-sequence C entries: a ``.cu``
    file alone (the f32 entry), or a ``csrc`` directory's
    ``flash_attention.cu`` and ``flash_attention_wgmma.cu`` (both)."""
    srcs = [path] if path.suffix == ".cu" else [
        path / "flash_attention.cu", path / "flash_attention_wgmma.cu"]
    nvcc = build._nvcc()
    objs = []
    for src in srcs:
        obj = work / f"{src.stem}.o"
        res = subprocess.run([nvcc, *build.COMPILE_FLAGS, "-o", str(obj),
                              str(src)], check=True, capture_output=True,
                             text=True)
        for ln in res.stdout.splitlines() + res.stderr.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  {src.name}: {ln.strip()}", flush=True)
        objs.append(str(obj))
    lib_path = work / f"lib{srcs[0].stem}.so"
    subprocess.run([nvcc, *build.LINK_FLAGS, "-o", str(lib_path), *objs],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_fwd.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32,
                                        i32, i32, i32, f32, f32, ptr]
    lib.flash_attention_fwd.restype = i32
    if len(srcs) > 1:
        lib.flash_attention_wgmma_fwd.argtypes = [
            ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i32, f32,
            f32, i32, ptr]
        lib.flash_attention_wgmma_fwd.restype = i32
    return lib


def has_bf16(lib) -> bool:
    return hasattr(lib, "flash_attention_wgmma_fwd")


def baseline_call(lib, q, k, v, window: int, softcap: float):
    """The baseline's kernel of q's dtype (bf16: the wgmma kernel at the
    built library's plan) on the current stream (the wrapper's checks are
    the caller's: contiguous on the card)."""
    b, s, h, dh = q.shape
    kh = k.shape[2]
    out = torch.empty_like(q)
    ptrs = (out.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    if q.dtype == torch.bfloat16:
        plan = ops.plan_wgmma(b, s, h, kh, dh, q.dtype)
        err = lib.flash_attention_wgmma_fwd(
            *ptrs, b, s, h, kh, dh, plan.g_blk, plan.bq, window, softcap,
            dh ** -0.5, plan.smem_bytes, stream)
    else:
        err = lib.flash_attention_fwd(*ptrs, b, s, h, kh, dh, window,
                                      softcap, dh ** -0.5, stream)
    if err:
        raise RuntimeError(f"baseline launch failed ({err})")
    return out


def sdpa(q, k, v, window: int):
    """SDPA in f32 on the same inputs: the causal window as a boolean
    mask, the kv head expanded (``chip_smoke.check_flash``'s library
    call)."""
    import torch.nn.functional as F
    s, h, kh = q.shape[1], q.shape[2], k.shape[2]
    pos = torch.arange(s, device=q.device)
    mask = pos[:, None] >= pos[None, :]
    if window:
        mask &= (pos[:, None] - pos[None, :]) < window
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(h // kh, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(h // kh, dim=2).transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask)


def run_case(case, baselines) -> dict:
    from chip_smoke import F32_PEAK, TF32_SPLIT_PEAK, time_ms
    label, b, s, h, kh, dh, window, cap, dtype, timed = case
    dt, tol = getattr(torch, dtype), TOL[dtype]
    g = torch.Generator(device="cuda").manual_seed(s + h)
    q = (torch.randn((b, s, h, dh), generator=g, device="cuda") * 2).to(dt)
    k = (torch.randn((b, s, kh, dh), generator=g, device="cuda") * 2).to(dt)
    v = torch.randn((b, s, kh, dh), generator=g, device="cuda").to(dt)
    want = ref.flash_attention_ref(q, k, v, window=window,
                                   softcap=cap).float()
    calls = {"built": lambda: ops.flash_attention(q, k, v, window=window,
                                                  softcap=cap)}
    for bname, lib in baselines.items():
        if dt == torch.float32 or has_bf16(lib):
            calls[bname] = (lambda lib=lib: baseline_call(lib, q, k, v,
                                                          window, cap))
    row = {"case": label, "shape": {"B": b, "S": s, "H": h, "Kh": kh,
                                    "Dh": dh, "window": window,
                                    "softcap": cap, "dtype": dtype}}
    outs = {}
    for name, fn in calls.items():
        got = outs[name] = fn()
        torch.cuda.synchronize()
        diff = (got.float() - want).abs()
        row[f"{name}_max_abs_diff"] = float(diff.max())
        row[f"{name}_within_tol"] = bool(
            (diff <= tol + tol * want.abs()).all()
            and torch.isfinite(got).all())
        if name != "built":
            row[f"{name}_bitwise"] = bool(torch.equal(got, outs["built"]))
    del want, outs
    if timed:
        flops = 4 * dh * ops.causal_pairs(s, window) * b * h
        others = [n for n in calls if n != "built"]
        for name in ["built"] + others + others + ["built"]:
            row.setdefault(f"{name}_ms", []).append(
                time_ms(torch, calls[name], iters=10, warmup=2))
        if not cap:
            row["sdpa_ms"] = time_ms(torch, sdpa(q, k, v, window), iters=5,
                                     warmup=2)
        row["flops"] = flops
        for name in calls:
            ms = min(row[f"{name}_ms"])
            row[f"{name}_tflops"] = flops / ms / 1e9
            row[f"{name}_share_165"] = flops / TF32_SPLIT_PEAK * 1e3 / ms
            row[f"{name}_share_67"] = flops / F32_PEAK * 1e3 / ms
    print("  " + json.dumps(row), flush=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, action="append", default=[],
                    help="a .cu file with the f32 C entry, or another "
                         "checkout's flash_attention/csrc (repeatable)")
    ap.add_argument("--probe", action="store_true",
                    help="only the TF32-exact operand probes")
    ap.add_argument("--out", type=Path, default=None,
                    help="write every row as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tune_flash: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.device import resolve_device
    resolve_device("cuda")          # TF32 off, as on every entry point
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    res = build.build()
    section = res.log.split("== flash_attention.cu")[-1].split("\n==")[0]
    for ln in section.splitlines():     # ptxas: registers and spills
        if "registers" in ln or "spill" in ln or "Compiling" in ln:
            print("  " + ln.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        baselines = {}
        for i, path in enumerate(args.baseline):
            work = Path(tmp) / str(i)
            work.mkdir()
            name = (path.stem if path.suffix == ".cu"
                    else f"baseline{i}")
            baselines[name] = compile_baseline(path, work)
        if args.probe:
            rows = [probe(case, baselines) for case in PROBES]
        else:
            cases = CASES
            if any(has_bf16(lib) for lib in baselines.values()):
                from chip_smoke import FLASH_CASES, TP_FLASH_CASES
                cases += tuple(c[:-1] + (False,)
                               for c in FLASH_CASES + TP_FLASH_CASES)
            rows = [run_case(case, baselines) for case in cases]
            for name in baselines:
                held = [r[f"{name}_bitwise"] for r in rows
                        if f"{name}_bitwise" in r]
                print(f"  {name}: bitwise on {sum(held)} of {len(held)} "
                      f"shapes", flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": smi, "rows": rows}))
    return 0 if args.probe or all(r["built_within_tol"] for r in rows) \
        else 1


if __name__ == "__main__":
    sys.exit(main())
