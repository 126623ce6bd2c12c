"""Build and load the port's hand-written CUDA kernel library.

The library is one ``.cu`` file with a plain C interface, compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library and loaded with
``ctypes`` — no PyTorch headers, so a build takes seconds.  It is built at
first use, from the sources in the checkout only, into ``_build/`` next to
this file (listed in ``.gitignore``); the library is named by a hash of
its source and flags, so an edited source is rebuilt and a stale build is
never loaded.

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
from typing import NamedTuple

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE / "_build"
SOURCE = _HERE / "masked_agg" / "csrc" / "masked_agg_acc.cu"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class BuildResult(NamedTuple):
    path: Path
    seconds: float     # 0.0 when an earlier build of the same hash was found
    log: str           # nvcc's output (ptxas register/spill report)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is required "
                           "to build the port's kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build() -> BuildResult:
    """Build the library unless a build of this source exists.  Raises
    with nvcc's output if the build fails."""
    digest = hashlib.sha1(SOURCE.read_bytes() + repr(NVCC_FLAGS).encode())
    target = BUILD_DIR / f"libmasked_agg_{digest.hexdigest()[:12]}.so"
    if target.exists():
        return BuildResult(target, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"kernel build failed (nvcc exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, target)          # atomic: concurrent builds agree
    return BuildResult(target, time.perf_counter() - t0, proc.stdout)


def load() -> ctypes.CDLL:
    """The library, built first if needed."""
    return ctypes.CDLL(str(build().path))
