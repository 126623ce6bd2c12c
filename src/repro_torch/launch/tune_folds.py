"""Variants of the dense accumulating folds K1 and K2, timed on the card
beside the built kernels.

Each variant is the sources of K1 (``masked_agg_acc.cu``) and K2
(``masked_agg_acc_deq.cu``) under one edit (a tuning constant, or a cache
hint on the rows read once), built by nvcc into a library of its own
with the port's flags.  With ``--baseline DIR``
(the ``csrc`` directory of another checkout, e.g. a ``git archive`` of the
parent commit; repeatable), that checkout's K1 and K2 are one more
variant.  At the
ResNet round cell's mask (``chip_smoke.main_path_layout``), each of
``chip_smoke.time_fold``'s and ``check_deq``'s folds runs through the
port's wrapper on the built library and on the variant's, in turns (built,
variant, variant, built), on ``chip_smoke``'s two timers (the graph replay
and the replay with the L2 flushed), with the output held bitwise to the
built kernels' (and on an edge case untimed: a NaN row at weight 0, -0.0
in the accumulator, a simple fold).  Needs a card and nvcc; run from the
root of a checkout:

    python -m repro_torch.launch.tune_folds [--baseline DIR] [--out FILE]
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.masked_agg import ops

CSRC = Path(build.__file__).resolve().parent / "masked_agg" / "csrc"
FILES = ("masked_agg_acc.cu", "masked_agg_acc_deq.cu")
K2_THREADS = "constexpr int kThreads = 128;"
K2_UNROLL = "constexpr int kRowUnroll = 1;"
# (name, {file: (text, replacement)}): one edit of the built sources
VARIANTS = (
    ("K1 one group a thread",
     {FILES[0]: ("constexpr int kGroups = 2;", "constexpr int kGroups = 1;")}),
    ("K1 f32 rows unrolled by 4",
     {FILES[0]: ("static constexpr int kUnroll = 1;",
                 "static constexpr int kUnroll = 4;")}),
    ("K2 blocks of 256 threads",
     {FILES[1]: (K2_THREADS, K2_THREADS.replace("128", "256"))}),
    ("K2 rows unrolled by 2",
     {FILES[1]: (K2_UNROLL, K2_UNROLL.replace("1", "2"))}),
    ("streaming loads (__ldcs) of the rows read once",
     {f: ("return __ldg(p);", "return __ldcs(p);") for f in FILES}),
)


def _compile(sources, work: Path) -> ctypes.CDLL:
    """nvcc each ``.cu`` of ``sources`` (a directory's files) with the
    port's flags and link them into one library under ``work``."""
    nvcc = build._nvcc()
    objs = []
    for src in sorted(sources.glob("*.cu")):
        obj = work / (src.stem + ".o")
        subprocess.run([nvcc, *build.COMPILE_FLAGS, "-o", str(obj),
                        str(src)], check=True, capture_output=True)
        objs.append(str(obj))
    lib = work / "libvariant.so"
    subprocess.run([nvcc, *build.LINK_FLAGS, "-o", str(lib), *objs],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib))
    ptr, i64, cint = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.masked_agg_acc.argtypes = [ptr] * 5 + [i64, i64, cint, cint, ptr]
    lib.masked_agg_acc.restype = cint
    lib.masked_agg_acc_deq.argtypes = [ptr] * 6 + [i64, i64, cint, cint,
                                                   ptr]
    lib.masked_agg_acc_deq.restype = cint
    lib.masked_agg_error_string.argtypes = [cint]
    lib.masked_agg_error_string.restype = ctypes.c_char_p
    return lib


def variant_source(work: Path, edits: dict) -> Path:
    """The built sources under ``edits``, in a directory of ``work``."""
    out = work / "src"
    out.mkdir()
    for name in FILES:
        text = (CSRC / name).read_text()
        if name in edits:
            old, new = edits[name]
            if old not in text:
                raise RuntimeError(f"{name} no longer holds {old!r}")
            text = text.replace(old, new)
        (out / name).write_text(text)
    return out


@contextlib.contextmanager
def using(lib):
    """The port's wrappers launching from ``lib``."""
    saved = ops._lib
    ops._lib = lambda: lib
    try:
        yield
    finally:
        ops._lib = saved


def cases(mask):
    """(label, make fold) at the cell's mask: ``chip_smoke.time_fold``'s
    and ``check_deq``'s folds, each fold a function of the accumulator."""
    from chip_smoke import QB, Z
    g = torch.Generator(device="cuda").manual_seed(7)
    n = mask.numel()
    x = torch.randn((Z, n), generator=g, device="cuda")
    xb = x.to(torch.bfloat16)
    q = torch.randint(-127, 128, (Z, n), generator=g, device="cuda",
                      dtype=torch.int8)
    scales = torch.rand((Z, n // QB), generator=g, device="cuda") * 0.01
    ones, zeros = torch.ones((Z,), device="cuda"), torch.zeros((Z,),
                                                               device="cuda")
    five = torch.full((1,), float(Z), device="cuda")
    k1 = lambda rows, wm, wr: lambda acc: ops.masked_agg_acc_(acc, rows,
                                                             mask, wm, wr)
    k2 = lambda wr: lambda acc: ops.masked_agg_acc_deq_(
        acc, q, scales, mask, ones, wr, quant_block=QB)
    edge = x.clone()
    edge[2] = float("nan")
    return (("K1 complex f32 Z=5", k1(x, ones, ones)),
            ("K1 complex bf16 Z=5", k1(xb, ones, ones)),
            ("K1 simple f32 Z=5", k1(x, ones, zeros)),
            ("K1 simple f32 Z=1", k1(x[:1], five, five * 0)),
            ("K2 complex int8 Z=5", k2(ones)),
            ("K2 simple int8 Z=5", k2(zeros)),
            ("K1 edge (NaN row, -0.0, simple)",
             k1(edge, torch.tensor([1.0, 1.0, 0.0, 0.5, 1.0], device="cuda"),
                zeros)))


def compare(built, lib, name: str, folds, acc0) -> list:
    """Each fold on the built library and on ``lib``: bitwise, then timed
    in turns on both timers, ``(graph replay, L2 flushed)`` ms each (the
    edge case only bitwise)."""
    from chip_smoke import time_ms, time_ms_flushed
    rows = []
    for label, fold in folds:
        outs = []
        for which in (built, lib):
            acc = acc0.clone()
            with using(which):
                fold(acc)
            outs.append(acc.view(torch.int32))
        row = {"variant": name, "fold": label,
               "bitwise": bool(torch.equal(*outs))}
        if not label.startswith("K1 edge"):
            acc = acc0.clone()
            for key, which in (("built_ms", built), ("variant_ms", lib),
                               ("variant_ms", lib), ("built_ms", built)):
                with using(which):
                    t = (time_ms(torch, lambda: fold(acc)),
                         time_ms_flushed(torch, lambda: fold(acc)))
                row.setdefault(key, []).append(t)
        rows.append(row)
        print("  " + json.dumps(row), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, action="append", default=[],
                    help="another checkout's masked_agg/csrc directory "
                         "(repeatable)")
    ap.add_argument("--out", type=Path, default=None,
                    help="write every row as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tune_folds: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    built = ops._lib()
    mask = chip_smoke.main_path_layout(torch)[1]
    folds = cases(mask)
    g = torch.Generator(device="cuda").manual_seed(8)
    acc0 = torch.randn((mask.numel(),), generator=g, device="cuda")
    acc0[::7] = -0.0
    variants = list(VARIANTS) + [(f"baseline {b}", b)
                                 for b in args.baseline]
    rows = []
    for name, edits in variants:
        print(f"[{name}]", flush=True)
        with tempfile.TemporaryDirectory() as tmp:
            work = Path(tmp)
            if isinstance(edits, Path):
                src = work / "src"
                src.mkdir()
                for f in FILES:
                    shutil.copy(edits / f, src)
            else:
                src = variant_source(work, edits)
            rows += compare(built, _compile(src, work), name, folds, acc0)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": smi, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
