"""The work a kernel wrapper does, reported to the walks that count it.

A kernel launched through ctypes belongs to no PyTorch op, so no dispatch
mode sees it; and on the CPU a wrapper's plain version is a string of
PyTorch ops that says nothing of the kernel's own traffic.  So each
wrapper runs its kernel, its plain version or its ``meta`` path inside
:func:`kernel`, with the flops and bytes of the function it computes —
the counts ``PERF.md`` §6's bounds use: each operand read once, each
result written once, the products and sums the function needs.  A walk
(``roofline/torch_walk.py``) that is active adds that work and leaves out
the ops inside; with no walk active :func:`kernel` costs one list check.
"""

from __future__ import annotations

import contextlib
from typing import List

import torch

# the active walks, innermost last; each has kernel_begin(name, flops,
# nbytes) and kernel_end()
WALKS: List = []

_NOTHING = contextlib.nullcontext()


@contextlib.contextmanager
def _report(name: str, flops: float, nbytes: float):
    walks = list(WALKS)
    for w in walks:
        w.kernel_begin(name, flops, nbytes)
    try:
        yield
    finally:
        for w in reversed(walks):
            w.kernel_end()


def kernel(name: str, flops: float, nbytes: float):
    """A context to run one kernel call in (module docstring)."""
    if not WALKS:
        return _NOTHING
    return _report(name, flops, nbytes)


def nbytes(*tensors) -> int:
    """Bytes of the given tensors (``None`` counts 0)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def refuse_dtensor(name: str, *tensors) -> None:
    """Raise ``TypeError`` if any of ``tensors`` is a DTensor: a kernel
    launches on a local tensor's pointer, so a sharded step hands each
    rank's shard to the wrapper through
    ``torch.distributed.tensor.experimental.local_map``."""
    if not torch.distributed.is_available():
        return
    from torch.distributed.tensor import DTensor
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"{name} takes local tensors, not DTensors: call it "
                        f"through torch.distributed.tensor.experimental."
                        f"local_map on each rank's shard")
