"""Server aggregation — FedHeN Alg. 1 ln. 16-22, plus NoSide and Decouple.

The port of ``repro.core.aggregate``'s three entry points:

* **One-shot** (``fedhen_server_update`` / ``decouple_server_update`` /
  ``masked_cohort_mean``): a whole stacked cohort reduced at once, in
  plain torch — the oracle both streaming engines are tested against.
* **Flat streaming** (``streaming_*``, the production fold, every wire).
  :class:`StreamState` carries one flat f32 accumulator of *unnormalized*
  masked sums (plus a second one for decouple).  Each trained chunk
  arrives packed in one contiguous ``(Z, n_flat)`` buffer and is folded
  with ONE launch that updates the accumulator in place (two for
  decouple): ``masked_agg_acc_`` (K1) on the f32/bf16 stream,
  ``masked_agg_acc_deq_`` (K2) on the int8 wire.  Delta-mode uploads (wire
  v2) arrive as a :class:`SparseChunk` and fold through
  :func:`streaming_fold_deltas`.  Normalization and unpacking happen once,
  at :func:`streaming_finalize`.
* **Tree streaming** (``tree_streaming_*``, ``FedConfig.agg_engine =
  "tree"``, the f32/bf16 wires): per-leaf f32 sums, the leaves views of
  one flat accumulator laid out like a packed row.  A fold is ONE
  ``masked_agg_fold_`` (K4) launch that sums every leaf of the packed
  chunk buffer and adds it to its accumulator in the same pass (the
  reference adds each leaf's part after its kernel); decouple's second
  sum is plain torch (:func:`_gated_wsum_leaf`), as in the reference.

SCAFFOLD adds a flat ``cv_acc`` to either state: the control-variate
deltas fold through one more K1 launch (:func:`_fold_cv`) on both engines.

:func:`allreduce_state` sums either state across the ranks of a process
group, in place, in one coalesced ``all_reduce(SUM)``: the cohort-sharded
round step (``launch/steps.py``) folds each rank's clients into its own
state and then sums the states, which is the round's all-reduce.

:class:`EngineSpec` is the reference's one frozen description of a fold
engine, built once per trainer from its ``FedConfig``;
:func:`engine_attrs` turns it into the plain scalars of the telemetry
``run_config`` ledger, the reference's strings included.
:func:`make_engine` binds a spec to the reference's ``(init, fold,
finalize)`` triple over stacked parameter trees, on top of the
layout-first streaming functions above (the launch-side round step of
``launch/steps.py`` folds through it; the trainer calls the streaming
functions directly).  Both also take the reference's deprecated loose
keyword form, which warns and builds the same spec.

**Weight contract** (the reference's): ``valid`` is a per-client
coefficient; a weight of 0 gates the client's values before the multiply
(a NaN device at weight 0 can never poison the sums).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import comm, flatten, masking
from repro_torch.kernels.masked_agg.ops import (fold_plan, masked_agg_acc_,
                                                masked_agg_acc_deq_,
                                                masked_agg_fold_,
                                                masked_scatter_acc_)
from repro_torch.tree import Tree, tree_leaves, tree_map

ALGORITHMS = ("fedhen", "noside", "decouple")


# ---------------------------------------------------------------------------
# EngineSpec: the one object a fold engine is configured by
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class EngineSpec:
    """Everything a fold engine is configured by, in one frozen value
    (the reference's ``aggregate.EngineSpec``).  Built once with
    :meth:`from_config`; values the config cannot know (the mask tree, the
    layout, the flat mask) are attached with :meth:`bind`.  ``eq=False``:
    the mask fields hold tensors, so only identity compares."""

    engine: str = "flat"
    algorithm: str = "fedhen"
    mask: Tree = None
    layout: Optional[flatten.FlatLayout] = None
    flat_mask: Optional[torch.Tensor] = None
    block_n: int = 2048
    stream_dtype: Any = torch.float32
    wire: Optional[comm.WireSpec] = None
    variance_reduction: str = "none"

    def __post_init__(self):
        if self.engine not in ("flat", "tree"):
            raise ValueError(f"unknown agg engine {self.engine!r}")
        if self.algorithm not in ALGORITHMS:
            raise ValueError(self.algorithm)
        if (self.engine == "tree" and self.wire is not None
                and self.wire.is_quantized):
            raise ValueError("int8 wire requires the flat engine "
                             "(dequantizing fold is a flat-buffer op)")
        if (self.engine == "tree" and self.wire is not None
                and self.wire.uses_deltas):
            raise ValueError("compressed uploads (topk/stochastic/"
                             "error-feedback wire) require the flat engine "
                             "(the delta fold is a flat-buffer op)")

    @classmethod
    def from_config(cls, fed, *, mask: Tree = None,
                    layout: Optional[flatten.FlatLayout] = None,
                    flat_mask: Optional[torch.Tensor] = None,
                    wire: Optional[comm.WireSpec] = None) -> "EngineSpec":
        """Build the spec from a ``FedConfig`` (the knobs' one source)."""
        return cls(engine=fed.agg_engine, algorithm=fed.algorithm,
                   mask=mask, layout=layout, flat_mask=flat_mask,
                   block_n=fed.agg_block_n,
                   stream_dtype=getattr(torch, fed.agg_stream_dtype),
                   wire=wire, variance_reduction=fed.variance_reduction)

    def bind(self, **kw) -> "EngineSpec":
        """A copy with further values attached (mask, layout,
        flat_mask, ...)."""
        return dataclasses.replace(self, **kw)


def _dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype as numpy and JAX spell it: ``"float32"``,
    ``"bfloat16"``, ``"int8"`` (not ``"torch.float32"``)."""
    return str(dtype).rpartition(".")[2]


def _legacy_spec(where: str, **kw) -> EngineSpec:
    """The spec a deprecated loose-kwarg call builds, with the reference's
    warning naming the call site."""
    warnings.warn(f"{where} with loose engine kwargs is deprecated; "
                  f"pass an EngineSpec", DeprecationWarning, stacklevel=3)
    return EngineSpec(**kw)


def engine_attrs(engine, *, algorithm: Optional[str] = None,
                 block_n: Optional[int] = None,
                 stream_dtype: torch.dtype = torch.float32,
                 wire: Optional[comm.WireSpec] = None) -> dict:
    """Static description of a configured fold engine as plain scalars:
    what the telemetry ``run_config`` ledger records about the fold path,
    with the reference's keys and values (dtypes spelled as numpy and JAX
    spell them).  Takes an :class:`EngineSpec`, or the deprecated loose
    form (an engine name and keyword arguments)."""
    if isinstance(engine, EngineSpec):
        spec = engine
    else:
        spec = _legacy_spec(
            "engine_attrs(engine, algorithm=..., block_n=...)",
            engine=engine, algorithm=algorithm,
            block_n=2048 if block_n is None else block_n)
        spec = spec.bind(stream_dtype=stream_dtype, wire=wire)
    attrs = {
        "agg_engine": spec.engine,
        "algorithm": spec.algorithm,
        "agg_block_n": int(spec.block_n),
        "agg_stream_dtype": _dtype_name(spec.stream_dtype),
        "variance_reduction": spec.variance_reduction,
    }
    if spec.wire is not None:
        attrs.update({
            "wire_dtype": _dtype_name(spec.wire.payload_dtype),
            "wire_quantized": bool(spec.wire.is_quantized),
            "wire_quant_block": int(spec.wire.quant_block)
            if spec.wire.is_quantized else 0,
            "wire_topk_frac": float(spec.wire.topk_frac),
            "wire_stochastic": bool(spec.wire.stochastic),
            "wire_error_feedback": bool(spec.wire.error_feedback),
        })
    return attrs


# ---------------------------------------------------------------------------
# One-shot server updates (the oracles)
# ---------------------------------------------------------------------------

def _gated_wsum_leaf(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """f32 weighted sum of one stacked leaf ``(Z, ...)`` over the cohort
    axis, gated before the multiply (a NaN device at weight 0 adds
    nothing)."""
    w = weights.reshape((-1,) + (1,) * (x.dim() - 1)).to(torch.float32)
    xf = torch.where(w > 0, x.to(torch.float32), 0.0)
    return torch.sum(xf * w, dim=0)


def _wmean(stacked: Tree, weights: torch.Tensor) -> Tree:
    """Weighted mean over the leading cohort axis; ``weights`` already
    normalized."""
    return tree_map(lambda x: _gated_wsum_leaf(x, weights).to(x.dtype),
                    stacked)


def _norm_weights(raw: torch.Tensor) -> torch.Tensor:
    total = raw.sum()
    return torch.where(total > 0, raw / torch.clamp(total, min=1e-12),
                       torch.zeros_like(raw))


def fedhen_server_update(cohort: Tree, is_simple: torch.Tensor,
                         valid: torch.Tensor, mask: Tree) -> Tree:
    """FedHeN / NoSide server step on a stacked cohort (leaves ``(Z,
    ...)``): inside M the mean over every valid device (Alg. 1 ln. 18),
    outside M the mean over valid complex devices (ln. 22)."""
    valid_f = valid.to(torch.float32)
    mean_all = _wmean(cohort, _norm_weights(valid_f))
    mean_complex = _wmean(cohort, _norm_weights(valid_f * ~is_simple))
    return masking.where_mask(mask, mean_all, mean_complex)


def decouple_server_update(cohort: Tree, is_simple: torch.Tensor,
                           valid: torch.Tensor, mask: Tree
                           ) -> Tuple[Tree, Tree]:
    """Decouple (Alg. 3): ``(simple host, new complex)`` — M from the
    simple devices only, everything else (and the complex model) from the
    complex devices only."""
    valid_f = valid.to(torch.float32)
    mean_simple = _wmean(cohort, _norm_weights(valid_f * is_simple))
    mean_complex = _wmean(cohort, _norm_weights(valid_f * ~is_simple))
    return masking.where_mask(mask, mean_simple, mean_complex), mean_complex


def masked_cohort_mean(cohort: Tree, weights_m: torch.Tensor,
                       weights_rest: torch.Tensor, mask: Tree) -> Tree:
    """Different normalized cohort weights inside and outside M."""
    return masking.where_mask(mask, _wmean(cohort, weights_m),
                              _wmean(cohort, weights_rest))


# ---------------------------------------------------------------------------
# Shared streaming helpers
# ---------------------------------------------------------------------------

def _chunk_weights(is_simple: torch.Tensor, valid: torch.Tensor,
                   algorithm: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw (unnormalized) per-client weights of one chunk.

    ``w_in`` weights the inside-M accumulator: every valid device for
    fedhen/noside (Alg. 1 ln. 18), simple devices only for decouple.
    ``w_out`` weights outside M: complex devices only (ln. 22)."""
    if algorithm not in ALGORITHMS:
        raise ValueError(algorithm)
    valid_f = valid.to(torch.float32)
    w_in = valid_f * is_simple if algorithm == "decouple" else valid_f
    w_out = valid_f * (~is_simple)
    return w_in, w_out


def _safe_inv(tot: torch.Tensor) -> torch.Tensor:
    """1/tot with the zero-weight-group guard (0 -> 0, never NaN)."""
    return torch.where(tot > 0, 1.0 / torch.clamp(tot, min=1e-12),
                       torch.zeros_like(tot))


class StreamState(NamedTuple):
    """Running sums of one round's chunked aggregation.

    ``acc``: flat f32 sums — inside M ``sum_z w_in[z] x[z]``, outside M
    ``sum_z w_out[z] x[z]``.  ``acc_out`` (decouple only, else ``None``):
    the whole-vector ``w_out`` sums.  ``tot_in`` / ``tot_out``: the 0-d
    weight totals finalize divides by.  ``cv_acc`` (SCAFFOLD only, else
    ``None``): the raw flat sum of the control-variate deltas, which the
    round divides by ``n_devices`` itself.  All on the round's device; the
    fold updates ``acc``/``acc_out``/``cv_acc`` in place."""
    acc: torch.Tensor
    acc_out: Optional[torch.Tensor]
    tot_in: torch.Tensor
    tot_out: torch.Tensor
    cv_acc: Optional[torch.Tensor] = None


def streaming_init(layout: flatten.FlatLayout, algorithm: str,
                   device, *, scaffold: bool = False) -> StreamState:
    """Zero accumulators for one round (``(n_flat,)`` f32 each; a
    ``cv_acc`` too with ``scaffold``)."""
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    acc_out = zeros(layout.n_flat) if algorithm == "decouple" else None
    cv_acc = zeros(layout.n_flat) if scaffold else None
    return StreamState(zeros(layout.n_flat), acc_out, zeros(), zeros(),
                       cv_acc)


def _fold_cv(cv_acc: Optional[torch.Tensor], cv_chunk: torch.Tensor,
             flat_mask: torch.Tensor, w_in: torch.Tensor,
             w_out: torch.Tensor) -> None:
    """Fold a ``(Z, n_flat)`` f32 chunk of control-variate deltas into
    ``cv_acc`` in place: the params' own masked K1 launch and weights, so
    a NaN client at weight 0 stays out.  Control variates are flat on
    both engines, so the flat and the tree engine share this fold."""
    if cv_acc is None:
        raise ValueError("cv_chunk passed but the stream state has no cv "
                         "accumulator (init it with scaffold=True)")
    masked_agg_acc_(cv_acc, cv_chunk, flat_mask, w_in, w_out)


def streaming_fold(state: StreamState, xz: torch.Tensor,
                   flat_mask: torch.Tensor, is_simple: torch.Tensor,
                   valid: torch.Tensor, algorithm: str, *,
                   wire: Optional[comm.WireSpec] = None,
                   cv_chunk: Optional[torch.Tensor] = None) -> StreamState:
    """Fold one packed chunk ``xz`` (``(Z, n_flat)``, f32 or bf16) into the
    sums: one in-place launch, two for decouple (its second accumulator
    uses ``w_out`` on both mask branches), one more for a SCAFFOLD
    ``cv_chunk`` (:func:`_fold_cv`).

    An int8 ``wire`` quantizes the (f32) chunk first, as the client-side
    encode, and folds it with the dequantizing K2; otherwise K1 folds the
    chunk in its own dtype (the trainer streams bf16 on a bf16 wire).
    ``is_simple`` (Z,) bool; ``valid`` (Z,) bool or f32 weights."""
    w_in, w_out = _chunk_weights(is_simple, valid, algorithm)
    if wire is not None and wire.is_quantized:
        q, scales = comm.quantize(xz, wire.quant_block)
        fold = lambda acc, w_m: masked_agg_acc_deq_(
            acc, q, scales, flat_mask, w_m, w_out,
            quant_block=wire.quant_block)
    else:
        fold = lambda acc, w_m: masked_agg_acc_(acc, xz, flat_mask, w_m,
                                                w_out)
    fold(state.acc, w_in)
    if state.acc_out is not None:
        fold(state.acc_out, w_out)
    if cv_chunk is not None:
        _fold_cv(state.cv_acc, cv_chunk, flat_mask, w_in, w_out)
    return state._replace(tot_in=state.tot_in + w_in.sum(),
                          tot_out=state.tot_out + w_out.sum())


class SparseChunk(NamedTuple):
    """One chunk's delta-mode uploads (wire v2, ``core/comm.py``).

    Each client's true upload is ``base + decode(row z)``, with ``base``
    the ``(n_flat,)`` f32 decoded broadcast the chunk trained on.  With
    top-k, ``values``/``indices`` are the compacted ``(Z, k)`` payloads
    (``scales`` grouped over the compacted axis, int8 only); with
    ``indices=None`` the payload is dense ``(Z, n_flat)`` (int8 with
    ``scales``, or bf16/f32)."""
    base: torch.Tensor
    values: torch.Tensor
    scales: Optional[torch.Tensor]
    indices: Optional[torch.Tensor]


def _fold_sparse(acc: torch.Tensor, sp: SparseChunk,
                 flat_mask: torch.Tensor, w_in: torch.Tensor,
                 w_out: torch.Tensor, quant_block: int) -> None:
    """Fold one delta-mode chunk into ``acc`` in place:
    ``sum_z w[z] (base + d[z])`` as ``(sum_z w[z]) base + sum_z w[z] d[z]``.

    The base term is ONE Z=1 K1 launch at the summed weights (the sums stay
    on the device; base is the finite broadcast, and an all-invalid chunk
    sums to weight 0).  The delta term is K3 for top-k payloads, K2 for
    dense int8 ones, K1 for dense bf16/f32 ones — each gating NaN and
    padding clients by their weight."""
    masked_agg_acc_(acc, sp.base[None], flat_mask, w_in.sum()[None],
                    w_out.sum()[None])
    if sp.indices is not None:
        masked_scatter_acc_(acc, sp.values, sp.scales, sp.indices,
                            flat_mask, w_in, w_out, quant_block=quant_block)
    elif sp.scales is not None:
        masked_agg_acc_deq_(acc, sp.values, sp.scales, flat_mask, w_in,
                            w_out, quant_block=quant_block)
    else:
        masked_agg_acc_(acc, sp.values, flat_mask, w_in, w_out)


def streaming_fold_deltas(state: StreamState, sp: SparseChunk,
                          flat_mask: torch.Tensor, is_simple: torch.Tensor,
                          valid: torch.Tensor, algorithm: str, *,
                          quant_block: int,
                          cv_chunk: Optional[torch.Tensor] = None
                          ) -> StreamState:
    """:func:`streaming_fold` for a delta-mode chunk: one
    :func:`_fold_sparse` into ``acc``, a second into ``acc_out`` for
    decouple (at ``w_out`` on both branches), and a SCAFFOLD ``cv_chunk``
    through :func:`_fold_cv`."""
    w_in, w_out = _chunk_weights(is_simple, valid, algorithm)
    _fold_sparse(state.acc, sp, flat_mask, w_in, w_out, quant_block)
    if state.acc_out is not None:
        _fold_sparse(state.acc_out, sp, flat_mask, w_out, w_out,
                     quant_block)
    if cv_chunk is not None:
        _fold_cv(state.cv_acc, cv_chunk, flat_mask, w_in, w_out)
    return state._replace(tot_in=state.tot_in + w_in.sum(),
                          tot_out=state.tot_out + w_out.sum())


_FINALIZE_SLICE = 1 << 28


def _normalized(acc: torch.Tensor, flat_mask: torch.Tensor,
                inv_in: torch.Tensor, inv_out: torch.Tensor) -> torch.Tensor:
    """``acc * where(flat_mask, inv_in, inv_out)`` as a new vector, the
    factors built a slice at a time: at gemma3-4b's width a whole-vector
    factor is one more 14.5 GiB beside the result, enough to run its
    training round out of memory.  Each element is the same product."""
    out = torch.empty_like(acc)
    for a in range(0, acc.numel(), _FINALIZE_SLICE):
        e = a + _FINALIZE_SLICE
        torch.mul(acc[a:e], torch.where(flat_mask[a:e], inv_in, inv_out),
                  out=out[a:e])
    return out


def streaming_finalize(state: StreamState, layout: flatten.FlatLayout,
                       flat_mask: torch.Tensor, algorithm: str
                       ) -> Tuple[Tree, Optional[Tree]]:
    """Normalize the flat sums and unpack them to parameter trees.

    Returns ``(new_complex, new_simple_host)``; the host is ``None`` except
    for decouple, whose new complex model is ``acc_out / tot_out`` and
    whose simple host is the combined vector.  A group with zero total
    weight yields zeros."""
    inv_in, inv_out = _safe_inv(state.tot_in), _safe_inv(state.tot_out)
    combined = flatten.unpack(layout, _normalized(state.acc, flat_mask,
                                                  inv_in, inv_out))
    if algorithm == "decouple":
        return flatten.unpack(layout, state.acc_out * inv_out), combined
    return combined, None


# ---------------------------------------------------------------------------
# Tree streaming (one K4 launch per fold)
# ---------------------------------------------------------------------------

class TreeStreamState(NamedTuple):
    """Per-leaf analogue of :class:`StreamState`: ``acc`` / ``acc_out`` are
    f32 trees shaped like one complex model; ``acc``'s leaves are views of
    ``acc_flat`` (``(n_flat,)`` f32, laid out like a packed row, padding
    0), which the fold updates.  ``cv_acc`` stays flat: the control
    variates are ``FlatLayout`` vectors on both engines."""
    acc_flat: torch.Tensor
    acc: Tree
    acc_out: Optional[Tree]
    tot_in: torch.Tensor
    tot_out: torch.Tensor
    cv_acc: Optional[torch.Tensor] = None


def tree_streaming_init(params_like: Tree, algorithm: str,
                        layout: flatten.FlatLayout, *,
                        scaffold: bool = False) -> TreeStreamState:
    """Zero f32 accumulators shaped like ``params_like`` (one unstacked
    model, on the round's device; ``acc`` as views of one flat buffer of
    ``layout``); a flat ``(n_flat,)`` ``cv_acc`` of ``layout`` too with
    ``scaffold``, as on the flat engine."""
    if algorithm not in ALGORITHMS:
        raise ValueError(algorithm)
    device = tree_leaves(params_like)[0].device
    flat = lambda: torch.zeros((layout.n_flat,), dtype=torch.float32,
                               device=device)
    acc_flat = flat()
    acc_out = (tree_map(lambda x: torch.zeros(
        x.shape, dtype=torch.float32, device=device), params_like)
        if algorithm == "decouple" else None)
    scalar = lambda: torch.zeros((), dtype=torch.float32, device=device)
    return TreeStreamState(acc_flat,
                           flatten.unpack(layout, acc_flat, cast=False),
                           acc_out, scalar(), scalar(),
                           flat() if scaffold else None)


def tree_streaming_fold(state: TreeStreamState, xz: torch.Tensor,
                        layout: flatten.FlatLayout, flat_mask: torch.Tensor,
                        is_simple: torch.Tensor, valid: torch.Tensor,
                        algorithm: str, *,
                        cv_chunk: Optional[torch.Tensor] = None
                        ) -> TreeStreamState:
    """Fold one packed chunk ``xz`` (``(Z, n_flat)`` in the stream dtype)
    into the per-leaf sums: every leaf's masked sum at ``flat_mask`` added
    to ``acc`` by one K4 launch on f32 rows (a bf16 stream is widened
    first, as the reference feeds its kernel); decouple adds the
    ``w_out`` sums of the leaves to ``acc_out`` in plain torch.  A
    SCAFFOLD ``cv_chunk`` folds through the flat :func:`_fold_cv`."""
    w_in, w_out = _chunk_weights(is_simple, valid, algorithm)
    x32 = xz.to(torch.float32)
    masked_agg_fold_(state.acc_flat, x32, flat_mask, w_in, w_out,
                     fold_plan(layout, xz.device))
    if state.acc_out is not None:
        tree_map(lambda a, x: a.add_(_gated_wsum_leaf(x, w_out)),
                 state.acc_out, flatten.unpack_stacked(layout, x32))
    if cv_chunk is not None:
        _fold_cv(state.cv_acc, cv_chunk, flat_mask, w_in, w_out)
    return state._replace(tot_in=state.tot_in + w_in.sum(),
                          tot_out=state.tot_out + w_out.sum())


def tree_streaming_finalize(state: TreeStreamState, leaf_masks: Tree,
                            algorithm: str, template: Optional[Tree] = None
                            ) -> Tuple[Tree, Optional[Tree]]:
    """Normalize the per-leaf sums: ``(new_complex, new_simple_host)`` as
    :func:`streaming_finalize` returns them, each leaf cast to its
    ``template`` leaf's dtype (f32 sums without one).  Leaf by leaf, so
    no f32 copy of the whole model is made beside the sums."""
    inv_in, inv_out = _safe_inv(state.tot_in), _safe_inv(state.tot_out)
    if template is None:
        template = state.acc
    combined = tree_map(lambda m, a, t: torch.where(
        torch.as_tensor(m, dtype=torch.bool, device=a.device),
        a * inv_in, a * inv_out).to(t.dtype), leaf_masks, state.acc,
        template)
    if algorithm == "decouple":
        return (tree_map(lambda a, t: (a * inv_out).to(t.dtype),
                         state.acc_out, template), combined)
    return combined, None


# ---------------------------------------------------------------------------
# Summing engine states across ranks (the cohort-sharded round)
# ---------------------------------------------------------------------------

def state_tensors(state) -> list:
    """Every tensor of a :class:`StreamState` or :class:`TreeStreamState`
    that a fold adds into: the accumulator(s) (a tree state's ``acc`` is
    views of ``acc_flat``; its decouple ``acc_out`` leaves each count),
    the weight totals and SCAFFOLD's ``cv_acc``."""
    if isinstance(state, TreeStreamState):
        accs = [state.acc_flat] + ([] if state.acc_out is None
                                   else tree_leaves(state.acc_out))
    else:
        accs = [state.acc] + ([] if state.acc_out is None
                              else [state.acc_out])
    return accs + [state.tot_in, state.tot_out] + (
        [] if state.cv_acc is None else [state.cv_acc])


def allreduce_bytes(state, *extra: torch.Tensor) -> int:
    """Bytes :func:`allreduce_state` sums for ``state`` and ``extra``."""
    return sum(t.numel() * t.element_size()
               for t in state_tensors(state) + list(extra))


def allreduce_state(state, group, *extra: torch.Tensor):
    """Sum :func:`state_tensors` of ``state`` and the ``extra`` tensors
    (the round's loss sum) across ``group``'s ranks, in place, as one
    coalesced ``all_reduce(SUM)`` (one a tensor where gloo reduces CUDA
    tensors: it cannot coalesce them); returns ``state``.  On one rank
    the sum is the identity, bit for bit."""
    import torch.distributed as dist
    tensors = state_tensors(state) + list(extra)
    if tensors[0].is_cuda and "nccl" not in str(dist.get_backend(group)):
        for t in tensors:
            dist.all_reduce(t, group=group)
        return state
    with dist._coalescing_manager(group=group):
        for t in tensors:
            dist.all_reduce(t, group=group)
    return state


# ---------------------------------------------------------------------------
# make_engine: the (init, fold, finalize) triple over stacked trees
# ---------------------------------------------------------------------------

def make_engine(engine, *, algorithm: Optional[str] = None, mask: Tree = None,
                layout: Optional[flatten.FlatLayout] = None,
                flat_mask: Optional[torch.Tensor] = None,
                block_n: int = 2048, stream_dtype: torch.dtype = torch.float32,
                wire: Optional[comm.WireSpec] = None
                ) -> Tuple[Callable, Callable, Callable]:
    """The reference's ``(init, fold, finalize)`` triple for a fold engine:

    * ``init(params_like) -> state`` (one unstacked model; only shapes,
      dtypes and the device are read);
    * ``fold(state, chunk, is_simple, valid[, cv_chunk=...]) -> state``,
      ``chunk`` a stacked tree (leaves ``(Z, ...)``), ``valid`` bool or f32
      weights;
    * ``finalize(state, template=...) -> (new_complex, simple_host)``,
      ``simple_host`` ``None`` except for decouple, each leaf cast to
      ``template``'s dtype.

    ``engine`` is an :class:`EngineSpec`; the deprecated loose form (an
    engine name and keyword arguments) warns and builds the same spec.
    The spec's ``layout`` and ``flat_mask`` may be unbound: the layout is
    then :func:`flatten.layout_of` the tree at hand (``block_n`` as its
    ``total_multiple``), and the flat mask is packed from ``mask`` once per
    layout and device.

    The flat engine packs each chunk (:func:`flatten.pack_stacked`) and
    folds it through :func:`streaming_fold`: K1 in the stream dtype (a
    bf16 wire's payload dtype on a bf16 wire), or on an int8 wire packed
    to f32, quantized per ``quant_block`` and folded by K2; decouple's
    second accumulator at ``w_out`` on both branches.  The tree engine
    folds through :func:`tree_streaming_fold` (K4); a tree spec with a
    non-identity wire streams at the wire's payload dtype."""
    if isinstance(engine, EngineSpec):
        spec = engine
    else:
        spec = _legacy_spec(
            "make_engine(engine, algorithm=..., mask=...)", engine=engine,
            algorithm=algorithm, mask=mask, layout=layout,
            flat_mask=flat_mask, block_n=block_n, stream_dtype=stream_dtype,
            wire=wire)
    if spec.engine == "tree" and spec.wire is not None \
            and not spec.wire.is_identity:
        spec = spec.bind(stream_dtype=spec.wire.payload_dtype)
    scaffold = spec.variance_reduction == "scaffold"
    packed_masks = {}

    def layout_for(tree: Tree, stacked: bool = False) -> flatten.FlatLayout:
        if spec.layout is not None:
            return spec.layout
        return flatten.layout_of(tree, total_multiple=spec.block_n,
                                 stacked=stacked)

    def mask_for(lay: flatten.FlatLayout, device) -> torch.Tensor:
        if spec.flat_mask is not None:
            return spec.flat_mask
        key = (lay.signature, str(device))
        if key not in packed_masks:
            packed_masks[key] = flatten.pack_mask(lay, spec.mask, device)
        return packed_masks[key]

    def device_of(tree: Tree):
        return tree_leaves(tree)[0].device

    if spec.engine == "flat":
        wire = spec.wire
        if wire is not None and wire.is_quantized:
            pack_dtype = torch.float32     # the client-side encode's input
        elif wire is not None and not wire.is_identity:
            pack_dtype = wire.payload_dtype
        else:
            pack_dtype = spec.stream_dtype

        def init(params_like: Tree) -> StreamState:
            return streaming_init(layout_for(params_like), spec.algorithm,
                                  device_of(params_like), scaffold=scaffold)

        def fold(state: StreamState, chunk: Tree, is_simple, valid, *,
                 cv_chunk: Optional[torch.Tensor] = None) -> StreamState:
            lay = layout_for(chunk, stacked=True)
            xz = flatten.pack_stacked(lay, chunk, dtype=pack_dtype)
            return streaming_fold(state, xz, mask_for(lay, xz.device),
                                  is_simple, valid, spec.algorithm,
                                  wire=wire, cv_chunk=cv_chunk)

        def finalize(state: StreamState, template: Tree = None
                     ) -> Tuple[Tree, Optional[Tree]]:
            if spec.layout is None and template is None:
                raise ValueError("finalize needs template= (or a spec with "
                                 "a layout) to unpack the flat sums")
            lay = layout_for(template)
            out = streaming_finalize(state, lay,
                                     mask_for(lay, state.acc.device),
                                     spec.algorithm)
            if template is None:
                return out
            cast = lambda tree: None if tree is None else tree_map(
                lambda a, t: a.to(t.dtype), tree, template)
            return cast(out[0]), cast(out[1])
    else:
        def init(params_like: Tree) -> TreeStreamState:
            return tree_streaming_init(params_like, spec.algorithm,
                                       layout_for(params_like),
                                       scaffold=scaffold)

        def fold(state: TreeStreamState, chunk: Tree, is_simple, valid, *,
                 cv_chunk: Optional[torch.Tensor] = None) -> TreeStreamState:
            lay = layout_for(chunk, stacked=True)
            xz = flatten.pack_stacked(lay, chunk, dtype=spec.stream_dtype)
            return tree_streaming_fold(state, xz, lay,
                                       mask_for(lay, xz.device), is_simple,
                                       valid, spec.algorithm,
                                       cv_chunk=cv_chunk)

        def finalize(state: TreeStreamState, template: Tree = None
                     ) -> Tuple[Tree, Optional[Tree]]:
            return tree_streaming_finalize(state, spec.mask, spec.algorithm,
                                           template)
    return init, fold, finalize
