"""K6 (both entries) against builds of edited copies of it, timed in turns.

Each ``--variant NAME@PATH`` is a copy of ``csrc/lru_scan.cu`` with the
same C entries under an edit (another tiling in its ``Tiling``
specialisations, another ring depth, another cache hint), built alone by
nvcc with the port's flags.  The port's wrappers launch it, planned by
``ops.scan_plan`` from the tilings the build reports
(``ops.kernel_layout``).  At recurrentgemma-2b's prefill shape
(4, 4096, 2560), the built library's entries (``ops.lru_scan`` in f32 and
bf16, ``ops.lru_scan_gated`` on bf16 x) and each variant's are held
bitwise to the plain versions, then timed in turns (built, each variant,
each variant, built) on ``chip_smoke.time_ms``, each beside its bound
(bytes at the HBM rate; the gated entry's also its gate math's FP32 and
MUFU instructions in the built library's SASS, ``chip_smoke.gate_ops``).
Needs a card and nvcc; run from the root of a checkout:

    python -m repro_torch.launch.tune_scan [--variant NAME@PATH ...]
        [--out FILE]
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rglru_scan import ops, ref

SHAPE = (4, 4096, 2560)
# (entry, x / a dtype)
ENTRIES = (("lru_scan", torch.float32), ("lru_scan", torch.bfloat16),
           ("lru_scan_gated", torch.bfloat16))


def build_variants(specs, work: Path) -> dict:
    """{name: library} of each ``NAME@PATH``, built alone by nvcc with the
    port's flags, one nvcc a variant, all started together; ptxas's
    registers and spills printed."""
    nvcc = build._nvcc()
    procs = []
    for spec in specs:
        name, _, path = spec.partition("@")
        if not path:
            raise SystemExit(f"--variant {spec!r}: need NAME@PATH")
        procs.append((name, subprocess.Popen(
            [nvcc, *build.COMPILE_FLAGS, "-o", str(work / f"{name}.o"),
             path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  {name}: {ln.strip()}", flush=True)
        so = work / f"lib{name}.so"
        subprocess.run([nvcc, *build.LINK_FLAGS, "-o", str(so),
                        str(work / f"{name}.o")], check=True,
                       capture_output=True)
        libs[name] = ops._bind(ctypes.CDLL(str(so)))
    return libs


@contextlib.contextmanager
def using(lib):
    """The port's wrappers launching from ``lib`` (None: the built
    library), planned from the tilings it reports."""
    saved = ops._lib, ops.PLAIN, ops.GATED
    if lib is not None:
        ops._lib = lambda: lib
        ops.PLAIN = ops.kernel_layout(False, torch.float32, lib)[0]
        ops.GATED = ops.kernel_layout(True, torch.float32, lib)[0]
    try:
        yield
    finally:
        ops._lib, ops.PLAIN, ops.GATED = saved


def inputs(entry: str, dtype) -> tuple:
    """The entry's inputs at ``SHAPE``, as ``chip_smoke.check_scan``
    draws them."""
    from chip_smoke import gate_inputs
    if entry == "lru_scan_gated":
        x, p, _ = gate_inputs(torch, *SHAPE, dtype, seed=5)
        c = -8.0 * torch.logaddexp(p["lam"], torch.zeros_like(p["lam"]))
        return (x, p["w_r"], p["b_r"], p["w_i"], p["b_i"], c, None)
    g = torch.Generator(device="cuda").manual_seed(9)
    a = torch.sigmoid(torch.randn(SHAPE, generator=g, device="cuda"))
    b = torch.randn(SHAPE, generator=g, device="cuda") * 0.2
    return (a.to(dtype), b.to(dtype))


def run(entry: str, dtype, libs: dict, counted: dict, bw: float) -> dict:
    """One entry on the built library and each variant: bitwise to the
    plain version, then timed in turns beside its bound."""
    from chip_smoke import F32_ISSUE, MUFU_RATE, time_ms
    args = inputs(entry, dtype)
    want = getattr(ref, entry + "_ref")(*args)
    calls = {"built": None, **libs}
    row = {"entry": entry, "dtype": str(dtype).replace("torch.", "")}
    for name, lib in calls.items():
        with using(lib):
            got = getattr(ops, entry)(*args)
        torch.cuda.synchronize()
        row[f"{name}_bitwise"] = bool(torch.equal(got, want))
    del want, got
    n, size = args[0].numel(), args[0].element_size()
    bound = (2 if entry == "lru_scan_gated" else 3) * n * size / bw * 1e3
    if entry == "lru_scan_gated":
        bound = max(bound, n * counted["fp32_per_element"] / F32_ISSUE * 1e3,
                    n * counted["mufu_per_element"] / MUFU_RATE * 1e3)
    row["bound_ms"] = bound
    for name in ["built", *libs, *libs, "built"]:
        with using(calls[name]):
            ms = time_ms(torch, lambda: getattr(ops, entry)(*args), iters=20,
                         warmup=3)
        row.setdefault(f"{name}_ms", []).append(ms)
    for name in calls:
        row[f"{name}_share"] = bound / min(row[f"{name}_ms"])
    print("  " + json.dumps(row), flush=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME@PATH: an edited copy of csrc/lru_scan.cu "
                         "(repeatable)")
    ap.add_argument("--out", type=Path, default=None,
                    help="write every row as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tune_scan: needs a CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import gate_ops, memory_rate
    from repro_torch.device import resolve_device
    resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    counted = gate_ops(torch)
    bw = memory_rate(torch.cuda.get_device_name(0))[0]
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(args.variant, Path(tmp))
        rows = [run(entry, dtype, libs, counted, bw)
                for entry, dtype in ENTRIES]
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": smi, "rows": rows}))
    return 0 if all(r[f"{name}_bitwise"] for r in rows
                    for name in ("built", *libs)) else 1


if __name__ == "__main__":
    sys.exit(main())
