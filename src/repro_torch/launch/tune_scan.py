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

Each ``--baseline PATH`` is ``csrc/lru_scan.cu`` from another checkout
(the parent's, unpacked with ``git archive``) whose gated entry gives out
no ``y_last``: built the same way and launched through the same wrappers,
which pass it every argument but ``y_last`` (:class:`Baseline`).  Every
row also records whether each build's output is bitwise the built
library's (``<name>_vs_built``): the gated entry without ``y_last``, with
and without ``y0``, against the parent's build.  Needs a card and nvcc;
run from the root of a checkout:

    python -m repro_torch.launch.tune_scan [--variant NAME@PATH ...]
        [--baseline PATH ...] [--out FILE]
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
# (entry, x / a dtype, the gated entry's y0 given)
ENTRIES = (("lru_scan", torch.float32, False),
           ("lru_scan", torch.bfloat16, False),
           ("lru_scan_gated", torch.bfloat16, False),
           ("lru_scan_gated", torch.bfloat16, True))


class Baseline:
    """A build of a ``csrc/lru_scan.cu`` whose gated entry takes no
    ``y_last`` (the C interface before it): its entries as the wrappers
    call them, the gated entry's ``y_last`` dropped (it must be null)."""

    def __init__(self, lib: ctypes.CDLL):
        ptr = ctypes.c_void_p
        i64, i32 = ctypes.c_int64, ctypes.c_int
        self.lib = ops._bind(lib)
        lib.lru_scan_gated.argtypes = [ptr] * 8 + [i64, i64, i64, i32, i32,
                                                   i32, i32, i32, ptr]

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def lru_scan_gated(self, y, x, w_r, b_r, w_i, b_i, c, y0, y_last,
                       *rest):
        if y_last is not None:
            raise ValueError("the baseline's gated entry gives out no "
                             "y_last")
        return self.lib.lru_scan_gated(y, x, w_r, b_r, w_i, b_i, c, y0,
                                       *rest)


def build_variants(specs, work: Path, baselines=()) -> dict:
    """{name: library} of each ``NAME@PATH`` and each baseline (named
    ``baseline<i>``, bound through :class:`Baseline`), built alone by nvcc
    with the port's flags, one nvcc a build, all started together;
    ptxas's registers and spills printed."""
    nvcc = build._nvcc()
    procs = []
    named = []
    for spec in specs:
        name, _, path = spec.partition("@")
        if not path:
            raise SystemExit(f"--variant {spec!r}: need NAME@PATH")
        named.append((name, path))
    named += [(f"baseline{i}", str(p)) for i, p in enumerate(baselines)]
    for name, path in named:
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
        lib = ctypes.CDLL(str(so))
        libs[name] = (Baseline(lib) if name.startswith("baseline")
                      else ops._bind(lib))
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


def inputs(entry: str, dtype, with_y0: bool = False) -> tuple:
    """The entry's inputs at ``SHAPE``, as ``chip_smoke.check_scan``
    draws them."""
    from chip_smoke import gate_inputs
    if entry == "lru_scan_gated":
        x, p, y0 = gate_inputs(torch, *SHAPE, dtype, seed=5,
                               with_y0=with_y0)
        c = -8.0 * torch.logaddexp(p["lam"], torch.zeros_like(p["lam"]))
        return (x, p["w_r"], p["b_r"], p["w_i"], p["b_i"], c, y0)
    g = torch.Generator(device="cuda").manual_seed(9)
    a = torch.sigmoid(torch.randn(SHAPE, generator=g, device="cuda"))
    b = torch.randn(SHAPE, generator=g, device="cuda") * 0.2
    return (a.to(dtype), b.to(dtype))


def run(entry: str, dtype, with_y0: bool, libs: dict, counted: dict,
        bw: float) -> dict:
    """One entry on the built library and each build: bitwise to the
    plain version and to the built library's output, then timed in turns
    beside its bound."""
    from chip_smoke import F32_ISSUE, MUFU_RATE, time_ms
    args = inputs(entry, dtype, with_y0)
    want = getattr(ref, entry + "_ref")(*args)
    calls = {"built": None, **libs}
    row = {"entry": entry, "dtype": str(dtype).replace("torch.", ""),
           "y0": with_y0}
    outs = {}
    for name, lib in calls.items():
        with using(lib):
            outs[name] = getattr(ops, entry)(*args)
        torch.cuda.synchronize()
        row[f"{name}_bitwise"] = bool(torch.equal(outs[name], want))
        row[f"{name}_vs_built"] = bool(torch.equal(outs[name],
                                                   outs["built"]))
    del want, outs
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
    ap.add_argument("--baseline", type=Path, action="append", default=[],
                    help="csrc/lru_scan.cu of another checkout whose gated "
                         "entry takes no y_last (repeatable)")
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
        libs = build_variants(args.variant, Path(tmp), args.baseline)
        rows = [run(entry, dtype, y0, libs, counted, bw)
                for entry, dtype, y0 in ENTRIES]
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": smi, "rows": rows}))
    return 0 if all(r[f"{name}_bitwise"] and r[f"{name}_vs_built"]
                    for r in rows for name in ("built", *libs)) else 1


if __name__ == "__main__":
    sys.exit(main())
