"""Per-client flat-vector state store: ``(N_clients, n_flat)`` rows.

The port of ``repro.core.state_store``: one packed ``FlatLayout`` row per
client — the error-feedback residuals of wire v2 here — behind the same
seam as the reference's:

* ``gather(ids)`` hands the round the O(cohort) ``(k, n_flat)`` block of
  sampled rows, as a tensor on the trainer's device;
* the round returns updated rows, and ``scatter(ids, rows)`` writes them
  back (real slots only: pad slots wrap real clients' ids);
* ``to_array()`` / ``load(array)`` carry the whole store through a
  checkpoint (``load`` checks the shape).

**Backends** (``FedConfig.state_store_backend``), with the reference's
``auto`` thresholds:

* ``"device"`` — one tensor on the trainer's device (a CUDA tensor on the
  card); gather/scatter are ``index_select`` / ``index_copy_``;
* ``"host"``   — one numpy array; gather is fancy indexing plus a copy of
  the O(cohort) block to the device;
* ``"mmap"``   — ``np.memmap`` over an unlinked temporary file (nothing to
  clean up: the file has no name and goes with its last handle); host
  memory stays O(touched pages); ``close()`` drops it at once;
* ``"auto"``   — ``device`` up to ``DEVICE_LIMIT_BYTES``, ``host`` up to
  ``HOST_LIMIT_BYTES``, else ``mmap``.
"""

from __future__ import annotations

import tempfile

import numpy as np
import torch

from repro_torch.device import DeviceLike

BACKENDS = ("auto", "device", "host", "mmap")

# auto thresholds (the reference's): keep the store off-device once it
# rivals a model's footprint, and out of host RAM once it rivals the
# machine's
DEVICE_LIMIT_BYTES = 64 * 1024 * 1024
HOST_LIMIT_BYTES = 4 * 1024 * 1024 * 1024


def resolve_backend(backend: str, nbytes: int) -> str:
    """Map ``"auto"`` to a concrete backend by store footprint."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown state-store backend {backend!r} "
                         f"(expected one of {BACKENDS})")
    if backend != "auto":
        return backend
    if nbytes <= DEVICE_LIMIT_BYTES:
        return "device"
    if nbytes <= HOST_LIMIT_BYTES:
        return "host"
    return "mmap"


class FlatStateStore:
    """``(N_clients, n_flat)`` float32 rows, zero at start, with a
    gather/scatter seam.  ``gathered_bytes`` / ``scattered_bytes`` count the
    rows moved, as the reference's do."""

    def __init__(self, n_clients: int, n_flat: int, *,
                 backend: str = "auto", device: DeviceLike = "cpu"):
        if n_clients <= 0:
            raise ValueError(f"n_clients must be > 0, got {n_clients}")
        if n_flat <= 0:
            raise ValueError(f"n_flat must be > 0, got {n_flat}")
        self.n_clients = int(n_clients)
        self.n_flat = int(n_flat)
        self.device = torch.device(device)
        self.backend = resolve_backend(backend, self.nbytes)
        self.gathered_bytes = 0
        self.scattered_bytes = 0
        self._file = None
        shape = (self.n_clients, self.n_flat)
        if self.backend == "device":
            self._rows = torch.zeros(shape, dtype=torch.float32,
                                     device=self.device)
        elif self.backend == "host":
            self._rows = np.zeros(shape, np.float32)
        else:
            self._file = tempfile.TemporaryFile(prefix="flat_state_")
            self._rows = np.memmap(self._file, dtype=np.float32, mode="w+",
                                   shape=shape)

    @property
    def nbytes(self) -> int:
        """Logical footprint (mmap: file size, not resident pages)."""
        return self.n_clients * self.n_flat * 4

    def _row_bytes(self, ids: np.ndarray) -> int:
        return int(ids.size) * self.n_flat * 4

    def gather(self, ids) -> torch.Tensor:
        """The sampled rows ``(k, n_flat)`` as a tensor on the store's
        device (a copy: later scatters do not change it)."""
        ids = np.asarray(ids, dtype=np.int64)
        self.gathered_bytes += self._row_bytes(ids)
        if self.backend == "device":
            return self._rows.index_select(
                0, torch.from_numpy(ids).to(self.device))
        return torch.from_numpy(np.ascontiguousarray(self._rows[ids])).to(
            self.device)

    def scatter(self, ids, rows) -> None:
        """Write updated rows back (unique real ids only), from a tensor
        on any device or a numpy array."""
        ids = np.asarray(ids, dtype=np.int64)
        self.scattered_bytes += self._row_bytes(ids)
        rows = torch.as_tensor(rows, dtype=torch.float32)
        if self.backend == "device":
            self._rows.index_copy_(0, torch.from_numpy(ids).to(self.device),
                                   rows.to(self.device))
        else:
            self._rows[ids] = rows.cpu().numpy()

    def to_array(self) -> np.ndarray:
        """The whole store as a host array (the checkpoint payload)."""
        if self.backend == "device":
            return self._rows.cpu().numpy()
        return np.asarray(self._rows)

    def load(self, array) -> None:
        """Restore every row from a checkpointed ``(n_clients, n_flat)``
        payload; any other shape raises ``ValueError``."""
        array = np.asarray(array, dtype=np.float32)
        if array.shape != (self.n_clients, self.n_flat):
            raise ValueError(
                f"state-store shape mismatch: checkpoint {array.shape}, "
                f"store {(self.n_clients, self.n_flat)}")
        if self.backend == "device":
            self._rows.copy_(torch.as_tensor(array))
        else:
            self._rows[...] = array

    def close(self) -> None:
        """Drop the mmap backend's file (no-op on the other backends)."""
        if self._file is not None:
            self._rows = np.zeros((0, self.n_flat), np.float32)
            self._file.close()
            self._file = None

    def __del__(self):
        # an __init__ that raised leaves no _file behind
        if getattr(self, "_file", None) is not None:
            self.close()
