"""Parameter-tree and trainer checkpoints in the reference's npz layout.

The port of ``repro.checkpoint.checkpoint``.  A checkpoint written by
either package restores in the other: the same key strings (dict keys
joined by ``/``, ``[i]`` for list indices, in JAX's leaf order), the
same ``__dtypes__`` and ``__meta__`` (UTF-8 JSON as uint8 arrays), bf16
stored as its uint16 pattern under the tag ``"bfloat16"``, and the same
meta keys and sidecar arrays.  numpy has no bf16 without ``ml_dtypes``,
so bf16 leaves cross as ``tensor.view(torch.int16)`` patterns and come
back through ``torch.from_numpy(...).view(torch.bfloat16)``.

* ``save_tree`` / ``restore_tree``: one tree; restore checks each leaf's
  shape against ``like`` and puts it on ``like``'s leaf's device.
* ``save_server`` / ``restore_server``: the server's ``complex`` tree
  (and decouple's ``simple_host``) with the round counter.
* ``save_server_flat`` / ``restore_server_flat``: each model as ONE
  packed vector through the trainer's ``FlatLayout`` and the wire encoder
  (``comm.encode_tree``): exact on the f32 wire, as lossy as the
  broadcast on the others; restore checks ``n_flat`` and the layout's
  ``signature``.
* ``save_trainer`` / ``restore_trainer``: either format plus the cohort
  sampler's identity facts (validated on restore: the sampler is pure in
  ``(seed, round)``, so no RNG state is saved), the client-state matrix
  (``__client_state__``) and, when on, SCAFFOLD's control variates
  (``__cv_store__``, ``__cv_global__``) and the error-feedback residuals
  (``__ef_store__``), raw f32; restoring a trainer that needs a sidecar
  the checkpoint lacks raises.

Writes go to the verbatim path through an open handle (``np.savez``
appends ``.npz`` to a bare filename, which would hide the file from a
resume), one array at a time: a leaf is copied to the host just before
it is written, so a save holds one leaf in host memory, not the model.
"""

from __future__ import annotations

import json
import os
import zipfile
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import comm, federated
from repro_torch.tree import Tree, tree_leaves, tree_unflatten, tree_map

_SEP = "/"
_CLIENT_STATE_KEY = "__client_state__"
_CV_STORE_KEY = "__cv_store__"
_CV_GLOBAL_KEY = "__cv_global__"
_EF_STORE_KEY = "__ef_store__"


def _paths(tree: Tree, prefix: Tuple[str, ...] = ()) -> List[str]:
    """Each leaf's key in JAX's leaf order (``tree_leaves``'s)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [p for i, x in enumerate(tree)
                for p in _paths(x, prefix + (f"[{i}]",))]
    return [_SEP.join(prefix)]


def _host(x: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(npz array, dtype tag) of one leaf: bf16 as its uint16 pattern."""
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = x.numpy()
    return arr, str(arr.dtype)


def _tensor(v: np.ndarray, tag: Optional[str], device) -> torch.Tensor:
    """A stored array back as a tensor on ``device``."""
    if tag == "bfloat16":
        bits = torch.from_numpy(np.asarray(v, order="C").view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.asarray(v, order="C")).to(device)


def _json(obj) -> np.ndarray:
    return np.frombuffer(json.dumps(obj).encode(), dtype=np.uint8)


def _read_json(data, key: str) -> Dict:
    return json.loads(bytes(data[key]).decode()) if key in data else {}


def _savez_exact(path: str,
                 arrays: Iterable[Tuple[str, np.ndarray]]) -> None:
    """What ``np.savez`` writes (one stored ``name.npy`` member an array),
    at the VERBATIM path, taking the arrays one at a time."""
    with open(path, "wb") as f, zipfile.ZipFile(
            f, mode="w", compression=zipfile.ZIP_STORED,
            allowZip64=True) as zf:
        for name, arr in arrays:
            with zf.open(name + ".npy", "w", force_zip64=True) as fid:
                np.lib.format.write_array(fid, np.asanyarray(arr),
                                          allow_pickle=False)


def _makedirs(path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)


def save_tree(path: str, tree: Tree, metadata: Optional[Dict] = None,
              extra_arrays: Optional[Dict[str, np.ndarray]] = None) -> None:
    """Save ``tree`` (and ``metadata`` as ``__meta__``, and dunder-named
    ``extra_arrays`` verbatim beside the leaves)."""
    _makedirs(path)
    dtypes: Dict[str, str] = {}

    def arrays() -> Iterator[Tuple[str, np.ndarray]]:
        for key, leaf in zip(_paths(tree), tree_leaves(tree)):
            arr, dtypes[key] = _host(leaf)
            yield key, arr
        yield "__dtypes__", _json(dtypes)
        if metadata is not None:
            yield "__meta__", _json(metadata)
        yield from (extra_arrays or {}).items()
    _savez_exact(path, arrays())


def restore_tree(path: str, like: Tree) -> Tuple[Tree, Dict]:
    """Restore into the structure of ``like``: each leaf's shape is
    checked (``ValueError``), a missing leaf raises ``KeyError``, and each
    leaf lands on the device of ``like``'s.  Returns ``(tree, meta)``."""
    with np.load(path) as data:
        dtypes = _read_json(data, "__dtypes__")
        meta = _read_json(data, "__meta__")
        leaves = []
        for key, ref in zip(_paths(like), tree_leaves(like)):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key}")
            v = data[key]
            if tuple(v.shape) != tuple(ref.shape):
                raise ValueError(f"shape mismatch at {key}: {v.shape} vs "
                                 f"{tuple(ref.shape)}")
            leaves.append(_tensor(v, dtypes.get(key), ref.device))
    return tree_unflatten(tree_map(lambda _: None, like), leaves), meta


def _parts(server) -> Dict[str, Tree]:
    parts = {"complex": server.complex}
    if server.simple_host is not None:
        parts["simple_host"] = server.simple_host
    return parts


def save_server(path: str, server, extra_meta: Optional[Dict] = None,
                extra_arrays: Optional[Dict[str, np.ndarray]] = None) -> None:
    save_tree(path, _parts(server), {"round": server.round,
                                     **(extra_meta or {})},
              extra_arrays=extra_arrays)


def restore_server(path: str, server) -> federated.ServerState:
    tree, meta = restore_tree(path, _parts(server))
    return federated.ServerState(complex=tree["complex"],
                                 simple_host=tree.get("simple_host"),
                                 round=int(meta.get("round", 0)))


# ---------------------------------------------------------------------------
# Flat-buffer checkpoints (one packed, wire-encoded vector a model)
# ---------------------------------------------------------------------------

def save_server_flat(path: str, server, layout, *, wire=None,
                     extra_meta: Optional[Dict] = None,
                     extra_arrays: Optional[Dict[str, np.ndarray]] = None
                     ) -> None:
    """Save the server as wire-encoded flat buffers: ``layout`` is the
    trainer's ``FlatLayout``, ``wire`` a ``comm.WireSpec`` (default f32,
    lossless)."""
    spec = wire if wire is not None else comm.WireSpec()
    _makedirs(path)
    parts = _parts(server)
    meta = {"round": server.round, "wire_dtype": spec.dtype,
            "quant_block": spec.quant_block, "n_flat": layout.n_flat,
            "layout_sig": layout.signature,
            "parts": sorted(parts), **(extra_meta or {})}

    def arrays() -> Iterator[Tuple[str, np.ndarray]]:
        for name, tree in parts.items():
            buf = comm.encode_tree(spec, layout, tree)
            yield f"{name}.payload", _host(buf.payload)[0]
            if buf.scales is not None:
                yield f"{name}.scales", _host(buf.scales)[0]
            del buf
        yield "__meta__", _json(meta)
        yield from (extra_arrays or {}).items()
    _savez_exact(path, arrays())


def restore_server_flat(path: str, server, layout) -> federated.ServerState:
    """Restore a :func:`save_server_flat` checkpoint into ``server``'s
    structure and device; a different ``n_flat`` or layout signature
    raises ``ValueError``."""
    device = tree_leaves(server.complex)[0].device
    with np.load(path) as data:
        meta = _read_json(data, "__meta__")
        if int(meta["n_flat"]) != layout.n_flat:
            raise ValueError(f"layout mismatch: checkpoint n_flat="
                             f"{meta['n_flat']} vs {layout.n_flat}")
        # n_flat collides easily (it is rounded up to block_n): the slot
        # table's fingerprint proves the offsets line up
        if meta["layout_sig"] != layout.signature:
            raise ValueError(f"layout mismatch: checkpoint slot table "
                             f"{meta['layout_sig']} vs {layout.signature} "
                             f"(same n_flat, different packing)")
        spec = comm.WireSpec(meta["wire_dtype"], int(meta["quant_block"]))
        trees = {}
        for name in meta["parts"]:
            payload = _tensor(data[f"{name}.payload"], spec.dtype, device)
            scales = (_tensor(data[f"{name}.scales"], None, device)
                      if f"{name}.scales" in data else None)
            trees[name] = comm.decode_tree(spec, layout,
                                           comm.WireBuffer(payload, scales))
    if ("simple_host" in trees) != (server.simple_host is not None):
        raise ValueError("checkpoint simple_host presence does not match "
                         "the trainer's algorithm")
    return federated.ServerState(complex=trees["complex"],
                                 simple_host=trees.get("simple_host"),
                                 round=int(meta.get("round", 0)))


# ---------------------------------------------------------------------------
# Trainer checkpoints (server state + sampler identity + client state)
# ---------------------------------------------------------------------------

def save_trainer(path: str, trainer, *, fmt: str = "tree") -> None:
    """Save a ``FederatedTrainer``'s resumable state: the server tree
    (``fmt="tree"``) or wire-encoded flat buffers (``fmt="flat"``), the
    sampler's identity facts, the client-state matrix, and SCAFFOLD's and
    error feedback's stores when they are on."""
    extra_meta = {
        "sampler": trainer.sampler.state_dict(),
        "client_state_columns": list(trainer.client_state.columns),
        "variance_reduction": trainer.fed.variance_reduction,
        "error_feedback": trainer.fed.error_feedback,
    }
    extra_arrays = {_CLIENT_STATE_KEY: np.asarray(trainer.client_state.array)}
    if trainer.cv_store is not None:
        extra_arrays[_CV_STORE_KEY] = trainer.cv_store.to_array()
        extra_arrays[_CV_GLOBAL_KEY] = trainer.cv_global.cpu().numpy()
    if trainer.ef_store is not None:
        extra_arrays[_EF_STORE_KEY] = trainer.ef_store.to_array()
    if fmt == "flat":
        save_server_flat(path, trainer.server, trainer.layout,
                         wire=trainer.wire, extra_meta=extra_meta,
                         extra_arrays=extra_arrays)
    elif fmt == "tree":
        save_server(path, trainer.server, extra_meta=extra_meta,
                    extra_arrays=extra_arrays)
    else:
        raise ValueError(f"unknown checkpoint format {fmt!r}")


def restore_trainer(path: str, trainer, *, fmt: str = "tree") -> None:
    """Restore :func:`save_trainer` state in place: ``trainer.server``,
    the validated sampler facts, the client-state matrix and the stores.
    A plain ``save_server`` / ``save_server_flat`` checkpoint restores
    too (no sampler facts to check, the fresh client-state matrix kept);
    a SCAFFOLD or EF trainer refuses a checkpoint without its sidecar."""
    if fmt == "flat":
        trainer.server = restore_server_flat(path, trainer.server,
                                             trainer.layout)
    elif fmt == "tree":
        trainer.server = restore_server(path, trainer.server)
    else:
        raise ValueError(f"unknown checkpoint format {fmt!r}")
    with np.load(path) as data:
        meta = _read_json(data, "__meta__")
        trainer.sampler.validate_state(meta.get("sampler"))
        if _CLIENT_STATE_KEY in data:
            trainer.client_state.load(
                data[_CLIENT_STATE_KEY],
                meta.get("client_state_columns",
                         list(trainer.client_state.columns)))
        if trainer.cv_store is not None:
            if _CV_STORE_KEY not in data:
                raise ValueError(
                    "trainer has variance_reduction='scaffold' but the "
                    "checkpoint carries no __cv_store__ sidecar (saved "
                    f"with variance_reduction="
                    f"{meta.get('variance_reduction', 'none')!r}); "
                    "resuming would silently reset the control variates")
            trainer.cv_store.load(data[_CV_STORE_KEY])
            trainer.cv_global = torch.from_numpy(
                np.asarray(data[_CV_GLOBAL_KEY], order="C")).to(
                    trainer.device)
        if trainer.ef_store is not None:
            if _EF_STORE_KEY not in data:
                raise ValueError(
                    "trainer has error_feedback=True but the checkpoint "
                    "carries no __ef_store__ sidecar (saved with "
                    f"error_feedback="
                    f"{meta.get('error_feedback', False)!r}); resuming "
                    "would silently drop the clients' compression "
                    "residuals")
            trainer.ef_store.load(data[_EF_STORE_KEY])
