"""A walk of one eager PyTorch call: flops, HBM traffic, collective bytes.

The port's counterpart of the reference's ``roofline/hlo_walk.py``, which
parses compiled HLO.  PyTorch runs eagerly and has no HLO, so this walk
runs the callable once under a ``TorchDispatchMode`` and counts every op
that reaches the dispatcher (below autograd: backward ops and
checkpoint recomputes included):

* ``flops`` — FlopCounterMode's own formulas (``torch.utils.flop_counter``'s
  registry: matmuls, convolutions and attention at 2 m n k), applied here
  rather than in a second mode so that a kernel wrapper's ops can be left
  out (below);
* ``hbm_bytes`` — each aten op's operand plus result bytes: the eager
  counterpart of ``hlo_walk``'s materialisation boundaries (in eager mode
  every op's result is materialised).  Views, metadata-only ops and
  uninitialised allocations move nothing and are not counted;
* ``collective_bytes`` — each ``c10d`` collective's result bytes on this
  rank (the reference's ``analysis.collective_bytes`` convention: an
  all-gather counts what it gathers), by type under the reference's names
  (``all-reduce``, ``all-gather``, ...), with ``collective_counts`` and
  ``total_collective_bytes``.

**DTensors.**  An op on DTensor arguments is handed back to DTensor
(``NotImplemented``), which runs it as the local ops and collectives of
this rank, and those are what the walk counts (as
``torch.distributed.tensor.debug.CommDebugMode`` does): under a live mesh
a walk counts one rank's work and the collectives it takes part in, the
implicit ones DTensor inserts included.  The ops DTensor runs on fake
tensors to propagate an op's sharding are not a rank's work and are not
counted.

**Kernels.**  The port's kernels launch through ctypes and belong to no
PyTorch op, so no dispatch mode sees them; their wrappers report their
work (``kernels/work.py``), which the walk adds to ``flops`` and
``hbm_bytes`` (and lists by kernel under ``kernels``), while it leaves out
the ops inside a wrapper (on the CPU, its plain version).  So a walk gives
the same counts on the card, on the CPU and on ``meta`` tensors.  The
reference's walk leaves its Pallas custom calls out (``custom-call`` is not
among its ``_BOUNDARY_OPS``); the port counts its kernels, so its counts
are at least the reference's for the same step.

The walk only observes: every op runs as it would without it, so results
under a walk are bitwise those without one.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import work

if torch.distributed.is_available():
    from torch.distributed.tensor import DTensor as _DTENSOR
else:
    _DTENSOR = None

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute", "broadcast")
# c10d / functional-collective op names -> the reference's collective types
_COLLECTIVE_OF = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast_": "broadcast", "broadcast": "broadcast",
}
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")
# ops that move no bytes: in-place metadata changes and uninitialised
# allocations (views are found by OpOverload.is_view)
_NO_TRAFFIC = {"squeeze_", "unsqueeze_", "t_", "transpose_", "as_strided_",
               "detach_", "set_", "resize_", "empty", "empty_like",
               "empty_strided", "new_empty", "new_empty_strided",
               "_local_scalar_dense", "sym_size", "sym_stride",
               "sym_numel", "sym_storage_offset", "lift_fresh"}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _bytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def collective_kind(func):
    """The reference's collective type of a dispatched op, or ``None``."""
    if func.namespace in _COLLECTIVE_NAMESPACES:
        return _COLLECTIVE_OF.get(func._opname)
    return None


class Collectives(TorchDispatchMode):
    """A mode that counts only the collectives a rank issues and their
    result bytes, by type (``counts``, ``bytes``), as :class:`Walk` does,
    for a timed run: the other ops pass through uncounted."""

    def __init__(self):
        super().__init__()
        self.counts: Dict[str, int] = {}
        self.bytes: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _DTENSOR is not None and any(issubclass(t, _DTENSOR)
                                        for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        kind = collective_kind(func)
        if kind is not None:
            self.counts[kind] = self.counts.get(kind, 0) + 1
            self.bytes[kind] = self.bytes.get(kind, 0) + _bytes(out)
        return out


class Walk(TorchDispatchMode):
    """The counting mode; use :func:`walk`."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.hbm_bytes = 0
        self.collective_bytes: Dict[str, int] = {c: 0 for c in COLLECTIVES}
        self.collective_counts: Dict[str, int] = {c: 0 for c in COLLECTIVES}
        self.kernels: Dict[str, Dict[str, float]] = {}
        self._in_kernel = 0

    # -- kernels/work.py's hooks -------------------------------------------

    def kernel_begin(self, name: str, flops: float, nbytes: float) -> None:
        if not self._in_kernel:
            k = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                               "bytes": 0})
            k["calls"] += 1
            k["flops"] += flops
            k["bytes"] += nbytes
            self.flops += flops
            self.hbm_bytes += nbytes
        self._in_kernel += 1

    def kernel_end(self) -> None:
        self._in_kernel -= 1

    def __enter__(self):
        work.WALKS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        work.WALKS.remove(self)
        return super().__exit__(*exc)

    # -- the ops -----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _DTENSOR is not None and any(issubclass(t, _DTENSOR)
                                        for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            return out      # DTensor's sharding propagation, not a rank's op
        if self._in_kernel:
            return out
        name = func._opname
        if func.namespace in _COLLECTIVE_NAMESPACES:
            kind = collective_kind(func)
            if kind is not None:
                self.collective_bytes[kind] += _bytes(out)
                self.collective_counts[kind] += 1
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if not func.is_view and name not in _NO_TRAFFIC:
            self.hbm_bytes += _bytes(args) + _bytes(kwargs) + _bytes(out)
        return out

    def counters(self) -> Dict:
        """The reference's keys (``hlo_walk.analyze``), plus ``kernels``."""
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "collective_bytes": dict(self.collective_bytes),
                "collective_counts": dict(self.collective_counts),
                "total_collective_bytes": sum(self.collective_bytes.values()),
                "kernels": {k: dict(v) for k, v in self.kernels.items()}}


def walk(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under a :class:`Walk`; returns
    ``(its result, the walk's counters)``."""
    with Walk() as w:
        out = fn(*args, **kwargs)
    return out, w.counters()
