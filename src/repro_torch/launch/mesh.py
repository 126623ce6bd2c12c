"""Meshes: the port of ``repro.launch.mesh``.

Two kinds, both with named axes ``("pod",) "data", "model"``:

* :class:`MeshShape` — axis names and sizes only, what the sharding spec
  math reads (the counterpart of ``jax.sharding.AbstractMesh``).
  :func:`make_production_mesh` returns the reference's TPU pod layouts,
  ``(16, 16)`` and ``(2, 16, 16)``, as shapes: they need no 256 ranks, and
  they are kept so that the port's specs can be held to the reference's.
  The dry-runs (``launch/dryrun.py``) work at these shapes on ``meta``
  tensors; the roofline constants they divide by are the H100's
  (``roofline/hw.py``), never a TPU's.
* :func:`make_device_mesh` — a live
  ``torch.distributed.device_mesh.DeviceMesh`` over a process group the
  caller has initialised (``init_process_group`` with its own address,
  world size and rank), with or without a ``pod`` axis.  Nothing here
  initialises a group.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch


class MeshShape:
    """Named axis sizes: ``.shape`` maps each axis name to its size,
    ``.axis_names`` orders them, ``.size`` is their product."""

    def __init__(self, sizes, names):
        sizes, names = tuple(int(n) for n in sizes), tuple(names)
        if len(sizes) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"need one distinct name per axis, got "
                             f"{names} for {sizes}")
        self.axis_names: Tuple[str, ...] = names
        self.shape: Dict[str, int] = dict(zip(names, sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    @classmethod
    def of(cls, mesh) -> "MeshShape":
        """The shape of a ``MeshShape`` or of a live ``DeviceMesh``."""
        if isinstance(mesh, cls):
            return mesh
        return cls(tuple(mesh.shape), tuple(mesh.mesh_dim_names))

    def __repr__(self) -> str:
        return f"MeshShape({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """Single pod: (16, 16) = 256 chips as ("data", "model").
    Multi-pod: (2, 16, 16) = 512 chips as ("pod", "data", "model")."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def make_debug_mesh(n_data: int = 2, n_model: int = 2) -> MeshShape:
    """A small ("data", "model") shape for spec tests."""
    return MeshShape((n_data, n_model), ("data", "model"))


def make_device_mesh(n_data: int, n_model: int, device: str, *,
                     n_pod: Optional[int] = None):
    """A live (``n_data``, ``n_model``) ``DeviceMesh`` named ("data",
    "model") over the initialised default process group, or with
    ``n_pod`` a (``n_pod``, ``n_data``, ``n_model``) one named ("pod",
    "data", "model"), ranks in row-major order, on ``device`` ("cuda" or
    "cpu").  Raises if no group is initialised or if the axes' product is
    not its world size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_device_mesh needs an initialised process "
                           "group (torch.distributed.init_process_group)")
    sizes, names = (n_data, n_model), ("data", "model")
    if n_pod is not None:
        sizes, names = (n_pod,) + sizes, ("pod",) + names
    world = dist.get_world_size()
    if math.prod(sizes) != world:
        raise ValueError(f"a {sizes} mesh needs {math.prod(sizes)} ranks, "
                         f"the group has {world}")
    ranks = torch.arange(world).reshape(sizes)
    return DeviceMesh(torch.device(device).type, ranks,
                      mesh_dim_names=names)


def data_axes(mesh) -> Tuple[str, ...]:
    """The axes the batch/cohort dimension shards over."""
    names = MeshShape.of(mesh).axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def model_axis_size(mesh) -> int:
    return MeshShape.of(mesh).shape.get("model", 1)
