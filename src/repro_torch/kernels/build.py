"""Build and load the port's hand-written CUDA kernel library.

Every ``kernels/*/csrc/*.cu`` source has a plain C interface.  Each is
compiled by its own ``nvcc`` process for Hopper (``sm_90a``), all started
together, and the objects are linked by one more ``nvcc`` into ONE shared
library loaded with ``ctypes`` — no PyTorch headers, so a build takes
seconds.  It is built at first use, from the sources in the checkout only,
into ``_build/`` next to this file (listed in ``.gitignore``); the library
is named by a hash of every source and the flags, so an edited source is
rebuilt and a stale build is never loaded.

Nothing here runs at import: the CPU tests import every module, and the
CPU has neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List, NamedTuple

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE / "_build"

ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                        "-Xptxas", "-v", "-c")
LINK_FLAGS = ARCH + ("-shared",)


class BuildResult(NamedTuple):
    path: Path
    seconds: float     # 0.0 when an earlier build of the same hash was found
    log: str           # nvcc's output (ptxas register/spill report)


def sources() -> List[Path]:
    """Every kernel source of the port, in a fixed order."""
    return sorted(_HERE.glob("*/csrc/*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is required "
                           "to build the port's kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _digest(srcs: List[Path]) -> str:
    h = hashlib.sha1(repr((COMPILE_FLAGS, LINK_FLAGS)).encode())
    for src in srcs:
        h.update(str(src.relative_to(_HERE)).encode() + b"\0")
        h.update(src.read_bytes() + b"\0")
    return h.hexdigest()[:12]


def build() -> BuildResult:
    """Build the library unless a build of these sources exists.  Raises
    with nvcc's output if any step fails."""
    srcs = sources()
    target = BUILD_DIR / f"libkernels_{_digest(srcs)}.so"
    if target.exists():
        return BuildResult(target, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [Path(work) / f"{i}_{src.stem}.o" for i, src in
                enumerate(srcs)]
        procs = [subprocess.Popen([nvcc, *COMPILE_FLAGS, "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(srcs, objs)]
        logs, failed = [], []
        for src, proc in zip(srcs, procs):
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(f"{src.name} (nvcc exit {proc.returncode})")
        if failed:
            raise RuntimeError("kernel build failed: " + ", ".join(failed)
                               + "\n" + "\n".join(logs))
        tmp = Path(work) / target.name
        link = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp),
                               *map(str, objs)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"kernel link failed (nvcc exit "
                               f"{link.returncode}):\n{link.stdout}")
        os.replace(tmp, target)          # atomic: concurrent builds agree
    return BuildResult(target, time.perf_counter() - t0,
                       "\n".join(logs) + link.stdout)


def load() -> ctypes.CDLL:
    """The library, built first if needed."""
    return ctypes.CDLL(str(build().path))
