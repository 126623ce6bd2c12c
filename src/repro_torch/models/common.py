"""Shared building blocks of the port's models: norms, embeddings, RoPE,
softcap, losses and init helpers.

Parameters are plain nested dicts of tensors, as in the reference.  Every
``init_*`` draws from an explicit ``torch.Generator`` and makes its
tensors on that generator's device.  The ResNet's activations are NCHW
(PyTorch's convention); the language models keep the reference's
``(B, S, ...)`` layouts.

Sharding is threaded through a :class:`Policy`, as in the reference:
model code names the logical axes of an activation
(``policy.constrain(x, ("batch", "seq", None))``) and the policy installed
by ``launch/sharding.py`` resolves them; :data:`NO_POLICY` (one device) is
the identity.  Over a live model axis the parameters and activations are
DTensors: :func:`local_apply` runs a function of local tensors (a kernel,
or a computation that separates along the sharded dims) on each rank's
shards, and :func:`apply_embedding` looks a vocabulary-sharded table up
that way (the vocab-parallel embedding); :func:`all_reduce` reduces a
local tensor over mesh dims (decode's merges over a sharded cache), and
:func:`gather_by_sum` gathers a sharded dim by one such all-reduce.

An init function given a :class:`ShapeGenerator` (device ``meta``) makes
``meta`` tensors of its leaves' shapes and dtypes and draws nothing:
``transformer.abstract_params`` is ``init_params`` through it.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Sharding policy hook
# ---------------------------------------------------------------------------

class Policy:
    """No-op default policy (one device).  See ``launch/sharding.py``.

    ``token_split``: whether the blocks run on each rank's tokens (a live
    ``seq2d`` / ``dp2d`` / ``seq2d_fsdp`` mesh, ``MeshPolicy``)."""

    token_split = False

    def constrain(self, x: torch.Tensor, axes) -> torch.Tensor:
        return x

    def gather_weights(self, tree):
        """``tree`` as a block uses it (``MeshPolicy`` gathers
        ``seq2d_fsdp``'s data-sharded weights)."""
        return tree


NO_POLICY = Policy()


def is_dtensor(x) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def local_apply(fn, out_placements, *args, in_grad_placements=None):
    """``fn(*args)`` on each rank's local shards: every DTensor argument is
    passed as its local tensor (no redistribution) and each output wrapped
    with ``out_placements`` (one list, or a tuple of lists for several
    outputs) over the first DTensor argument's mesh, through
    ``torch.distributed.tensor.experimental.local_map`` (differentiable:
    each input's gradient keeps its placements, or takes those of
    ``in_grad_placements``, one entry an argument, ``None`` for the
    input's own).  With no DTensor among ``args`` it is ``fn(*args)``.
    The caller guarantees that ``fn`` separates along the sharded dims."""
    if not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map

    def local(*xs):
        return fn(*(_ContiguousGrad.apply(x) if isinstance(
            x, torch.Tensor) and x.requires_grad else x for x in xs))
    if in_grad_placements is not None:
        in_grad_placements = tuple(
            g if g is not None or not is_dtensor(a) else list(a.placements)
            for g, a in zip(in_grad_placements, args))
    return local_map(local, out_placements=out_placements,
                     in_grad_placements=in_grad_placements)(*args)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous: a
    local gradient leaves ``local_map`` as a DTensor's shard, and DTensor's
    ``view`` (the backward of a later reshape) cannot take a non-contiguous
    one."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def unshard(x: torch.Tensor, dim: int) -> torch.Tensor:
    """A DTensor with dim ``dim`` gathered whole on every rank (its other
    placements kept); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    d = dim % x.dim()
    place = [Replicate() if isinstance(p, Shard) and p.dim == d else p
             for p in x.placements]
    return x if place == list(x.placements) else x.redistribute(
        x.device_mesh, place)


def all_reduce(x: torch.Tensor, op: str, mesh, dims) -> torch.Tensor:
    """A local tensor reduced by ``op`` (``"sum"`` or ``"max"``) over the
    mesh dims ``dims`` in turn: the functional all-reduce that DTensor's
    ``Partial -> Replicate`` issues, and never a gather."""
    from torch.distributed import _functional_collectives as funcol
    for d in dims:
        x = funcol.wait_tensor(funcol.all_reduce(x, op, (mesh, d)))
    return x


def gather_by_sum(x: torch.Tensor, dim: int, start: int, size: int, mesh,
                  dims) -> torch.Tensor:
    """A local slice ``x`` (rows ``[start, start + x.shape[dim])`` of a dim
    of ``size`` rows, split over the mesh dims ``dims``) whole on every
    rank: the slice written into a zeroed buffer at its offset, then one
    SUM :func:`all_reduce` over ``dims``.  Exactly the gathered tensor
    (each row has one nonzero term), except that the sum turns -0.0 into
    +0.0.  It replaces an all-gather, which gloo's functional collectives
    cannot run on CUDA tensors (``launch/probe_gloo.py``).  With no
    ``dims`` it is ``x``."""
    if not dims:
        return x
    shape = list(x.shape)
    shape[dim] = size
    buf = x.new_zeros(shape)
    buf.narrow(dim, start, x.shape[dim]).copy_(x)
    return all_reduce(buf, "sum", mesh, dims)


class GatherBySum(torch.autograd.Function):
    """:func:`gather_by_sum` over ``dims`` under autograd.  The backward
    takes the gathered tensor's gradient at this rank's rows, first summed
    over ``sum_dims`` (one all-reduce each): the mesh dims whose ranks each
    use another part of the gathered tensor (their terms of the loss
    differ).  Where every rank uses it whole and alike its gradient is
    replicated, and ``sum_dims`` is empty."""

    @staticmethod
    def forward(ctx, x, dim, start, size, mesh, dims, sum_dims):
        ctx.slot = (dim, start, x.shape[dim], mesh, tuple(sum_dims))
        return gather_by_sum(x, dim, start, size, mesh, dims)

    @staticmethod
    def backward(ctx, g):
        dim, start, n, mesh, sum_dims = ctx.slot
        if sum_dims:
            g = all_reduce(g.contiguous(), "sum", mesh, sum_dims)
        return (g.narrow(dim, start, n).contiguous(),) + (None,) * 6


class SliceRows(torch.autograd.Function):
    """Rows ``[start, start + n)`` of a tensor's dim ``dim`` (``size``
    rows, whole on every rank of the mesh dims ``dims``): this rank's share
    where a replicated tensor becomes sharded.  The backward gathers the
    shares' gradients whole by :func:`gather_by_sum` (one all-reduce), so
    neither direction issues an all-gather."""

    @staticmethod
    def forward(ctx, x, dim, start, n, mesh, dims):
        ctx.slot = (dim, start, x.shape[dim], mesh, tuple(dims))
        return x.narrow(dim, start, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        dim, start, size, mesh, dims = ctx.slot
        return (gather_by_sum(g.contiguous(), dim, start, size, mesh, dims),
                ) + (None,) * 5


def held_rows(size: int, mesh, mesh_dims) -> tuple:
    """``(start, stop)`` of the rows of a ``size``-row dim that this rank
    holds when the mesh dims ``mesh_dims`` shard it, nested in mesh order
    as DTensor splits it."""
    from repro_torch.launch.sharding import shard_rows
    start, stop = 0, size
    for i in mesh_dims:
        lo, hi = shard_rows(stop - start, mesh.get_local_rank(i),
                            mesh.size(i))
        start, stop = start + lo, start + hi
    return start, stop


def _gather_mesh_dim(x, i: int):
    """DTensor ``x`` with mesh dim ``i``'s shards of their tensor dim
    gathered (one all-reduce), ``Replicate`` there: the innermost mesh dim
    that shards that tensor dim."""
    from torch.distributed.tensor import Replicate
    d, mesh = x.placements[i].dim, x.device_mesh
    outer = [j for j in range(i) if x.placements[j].is_shard(d)]
    if any(x.placements[j].is_shard(d) for j in range(i + 1, mesh.ndim)):
        raise ValueError(f"gathering mesh dim {i} of {x.placements} would "
                         f"leave a split of dim {d} nested inside it")
    lo, hi = held_rows(x.shape[d], mesh, outer)
    start = held_rows(hi - lo, mesh, [i])[0]
    place = list(x.placements)
    place[i] = Replicate()
    if mesh.size(i) == 1:
        return local_apply(lambda t: t.view_as(t), place, x)
    return local_apply(lambda t: GatherBySum.apply(
        t, d, start, hi - lo, mesh, [i], []), place, x)


def _slice_mesh_dim(x, i: int, d: int):
    """DTensor ``x``, replicated over mesh dim ``i``, as ``Shard(d)``
    there: each rank keeps its rows (:class:`SliceRows`)."""
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    if any(x.placements[j].is_shard(d) for j in range(i + 1, mesh.ndim)):
        raise ValueError(f"splitting dim {d} over mesh dim {i} of "
                         f"{x.placements} would nest it outside a split")
    rows = x.to_local().shape[d]
    start, stop = held_rows(rows, mesh, [i])
    place = list(x.placements)
    place[i] = Shard(d)
    if mesh.size(i) == 1:
        return local_apply(lambda t: t.view_as(t), place, x)
    return local_apply(lambda t: SliceRows.apply(
        t, d, start, stop - start, mesh, [i]), place, x)


def redistribute_by_sum(x, placements):
    """DTensor ``x`` placed by ``placements`` through all-reduces only, in
    both directions of autograd: each ``Partial`` the target does not keep
    is reduced (an all-reduce), each shard the target does not keep is
    gathered innermost first (:class:`GatherBySum`, one all-reduce), then
    each new split keeps this rank's rows (:class:`SliceRows`, whose
    backward is one all-reduce); over a mesh dim of one rank either is a
    relabelling.  What DTensor's ``redistribute`` would do
    with a reduce-scatter, an all-gather or an all-to-all, which gloo
    cannot run on CUDA tensors (``launch/probe_gloo.py``)."""
    from torch.distributed.tensor import Replicate
    target = list(placements)
    cur = list(x.placements)
    if cur == target:
        return x
    reduced = [Replicate() if p.is_partial() and not t.is_partial() else p
               for p, t in zip(cur, target)]
    if reduced != cur:
        x = x.redistribute(x.device_mesh, reduced)
    for i in reversed(range(len(target))):
        if x.placements[i].is_shard() and x.placements[i] != target[i]:
            x = _gather_mesh_dim(x, i)
    for i, t in enumerate(target):
        if t.is_shard() and x.placements[i] != t:
            x = _slice_mesh_dim(x, i, t.dim)
    if list(x.placements) != target:
        raise ValueError(f"no all-reduce route from {cur} to {target}")
    return x


def batch_as(x, like):
    """DTensor ``x`` with its batch (dim 0) gathered over each mesh dim
    that splits it and not ``like``'s dim 0 (:func:`redistribute_by_sum`,
    an all-reduce a dim): a ``dp2d`` decode input, its batch over data and
    model, to a cache's batch split over data."""
    from torch.distributed.tensor import Replicate
    return redistribute_by_sum(x, [
        Replicate() if pl.is_shard(0) and not c.is_shard(0) else pl
        for pl, c in zip(x.placements, like.placements)])


class TokenSplit(Policy):
    """The policy of a block run on one rank's tokens (``transformer``'s
    token-split blocks): every constrain is the identity on its local
    tensors, and attention reads the sequence's split from it.  ``mesh``
    and ``dims``: the mesh dims that split the sequence (none where it is
    whole on the rank); ``start``: this rank's first position; ``size``:
    the sequence's length; ``seq2d``: the reference's ``seq2d`` attention
    (``chunk2d_attention``) rather than the chunked causal path;
    ``batch_dims`` and ``batch``: the mesh dims that split the batch and
    its whole row count (an MoE block's aux losses are the whole
    batch's)."""

    def __init__(self, mesh, dims, start: int, size: int, seq2d: bool,
                 batch_dims, batch: int):
        self.mesh, self.dims = mesh, list(dims)
        self.start, self.size, self.seq2d = start, size, seq2d
        self.batch_dims, self.batch = list(batch_dims), batch


def sharding_dims(x, dim: int) -> list:
    """The mesh dims whose placement of DTensor ``x`` shards its dim
    ``dim`` (none for a plain tensor)."""
    if not is_dtensor(x):
        return []
    return [i for i, pl in enumerate(x.placements) if pl.is_shard(dim)]


# ---------------------------------------------------------------------------
# On a rank's rows of a split sequence (the recurrent mixers: ``rglru``,
# ``xlstm``)
# ---------------------------------------------------------------------------

def seq_split(policy: Policy) -> Optional[TokenSplit]:
    """The token split of this rank's rows where it splits the
    sequence, else ``None``."""
    if isinstance(policy, TokenSplit) and policy.dims:
        return policy
    return None


def split_rank(split: TokenSplit, n: int) -> Tuple[int, int]:
    """``(q, r)``: this rank's place among the ``r`` ranks that split the
    sequence into runs of ``n`` rows (the policy splits only where the
    ranks divide it)."""
    r = 1
    for i in split.dims:
        r *= split.mesh.size(i)
    return split.start // n, r


def split_tails(x: torch.Tensor, split: TokenSplit, tw: int,
                grad: bool) -> torch.Tensor:
    """Every rank's last tw - 1 pre-conv rows, rank q's at rows
    ``[q (tw - 1), (q + 1) (tw - 1))`` of a (B, r (tw - 1), C) tensor,
    whole on every rank: one all-reduce (:class:`GatherBySum` under
    autograd, whose backward sums the rows' gradient over the ranks and
    keeps this rank's)."""
    n = x.shape[1]
    if n < tw - 1:
        raise ValueError(f"a rank's {n} rows hold no whole conv halo of "
                         f"{tw - 1} rows: split the sequence over fewer "
                         f"ranks")
    q, r = split_rank(split, n)
    tail = x[:, n - (tw - 1):].contiguous()
    args = (1, q * (tw - 1), r * (tw - 1), split.mesh, split.dims)
    if grad:
        return GatherBySum.apply(tail, *args, split.dims)
    return gather_by_sum(tail, *args)


def split_halo(tails: torch.Tensor, q: int,
               tw: int) -> Optional[torch.Tensor]:
    """Rank q's conv window: rank q - 1's tail, or ``None`` (zeros) on the
    first rank."""
    return None if q == 0 else tails[:, (q - 1) * (tw - 1):q * (tw - 1)]


def split_chain(run, split: TokenSplit, n: int, zeros: torch.Tensor,
                grad: bool = False, after: Optional[torch.Tensor] = None):
    """A recurrence over the ranks' runs of ``n`` rows, one rank after
    another: ``run(carry)`` -- this rank's rows from the state ``carry``
    that rank q - 1 hands on (``None`` on the first rank) -- returns ``(y,
    state)``, ``state`` a tensor like ``zeros`` (f32, contiguous).  Hop j
    is one SUM all-reduce of rank j's state (zeros on every other rank);
    rank j + 1 takes it as its carry, and the last hop gives every rank
    the last rank's state.  Returns ``(y, last)``.

    Under autograd (``grad``) each hop is a :class:`GatherBySum`, whose
    backward all-reduces the carry's gradient back to its owner, and each
    hop's input depends on the hop before it (on the other ranks through
    :class:`Keep`'s zeros; the first hop's on ``after``, a tensor of the
    block's that requires grad), so every rank's graph holds the hops as
    one chain and issues their backward all-reduces in one order, hop r -
    1 down to hop 0.  The caller ties ``last`` to its output with
    :class:`Keep`: autograd calls no backward of an unused output."""
    q, r = split_rank(split, n)
    y = carry = hop = None
    for j in range(r):
        if j == q:
            y, state = run(carry)
        else:
            state = Keep.apply(zeros, hop if j else after) if grad else zeros
        if grad:
            hop = GatherBySum.apply(state, 0, 0, state.shape[0], split.mesh,
                                    split.dims, split.dims)
        else:
            hop = all_reduce(state, "sum", split.mesh, split.dims)
        if j + 1 == q:
            carry = hop
    return y, hop


class Keep(torch.autograd.Function):
    """``y`` itself, whose backward also hands zero gradients to the
    tensors ``used``: gathered tensors a rank does not read (the first
    rank reads no halo and no carry), whose backward all-reduces the
    other ranks' need from every rank, in one order on every rank."""

    @staticmethod
    def forward(ctx, y, *used):
        ctx.like = [(u.shape, u.dtype, u.device) for u in used]
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return (g,) + tuple(torch.zeros(shape, dtype=dtype, device=device)
                            for shape, dtype, device in ctx.like)


class ShapeGenerator:
    """Stands in for a ``torch.Generator`` where only the shapes of a
    parameter tree are wanted: its device is ``meta``, so the init
    functions make ``meta`` tensors and draw nothing (no ``meta``
    generator exists to draw from)."""

    device = torch.device("meta")


def _shapes_only(generator) -> bool:
    return generator.device.type == "meta"


def rand(generator, shape) -> torch.Tensor:
    """Uniform [0, 1) f32 draws on the generator's device."""
    if _shapes_only(generator):
        return torch.empty(shape, device="meta")
    return torch.rand(shape, generator=generator, device=generator.device)


def dense_init(generator: torch.Generator, shape, fan_in: Optional[int] = None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Truncated-normal (+-2 std) fan-in init, the reference's scheme (its
    draws come from JAX keys, so the values differ), drawn in f32 on the
    generator's device and stored in ``dtype``."""
    if _shapes_only(generator):
        return torch.empty(shape, dtype=dtype, device="meta")
    if fan_in is None:
        fan_in = shape[0] if len(shape) > 1 else shape[-1]
    out = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (out / math.sqrt(max(fan_in, 1))).to(dtype)


def embed_init(generator: torch.Generator, shape,
               dtype: torch.dtype) -> torch.Tensor:
    """Normal(0, 0.02) in f32, stored in ``dtype``."""
    if _shapes_only(generator):
        return torch.empty(shape, dtype=dtype, device="meta")
    out = torch.randn(shape, generator=generator, dtype=torch.float32,
                      device=generator.device)
    return (out * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm (gemma-style: the weight is a residual around 1)
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, dtype: torch.dtype, device=None) -> dict:
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def apply_rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6
                  ) -> torch.Tensor:
    """``x / rms(x) * (1 + scale)`` in f32, returned in ``x.dtype``."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * (1.0 + p["scale"].float())).to(x.dtype)


# ---------------------------------------------------------------------------
# Softcap (gemma-2) and rotary position embeddings
# ---------------------------------------------------------------------------

def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    """``1 / theta ** (2i / head_dim)`` in f32, (head_dim // 2,): the
    exponent in f32, the power and its reciprocal in f64, rounded once --
    the values the reference's jitted programs fold on the host.  An f32
    ``pow`` kernel is off by up to an ulp, which a position in the
    thousands turns into an angle off by ~1e-5."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return (1.0 / theta ** exponent.double()).float()


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Half-split rotation.  x: (B, S, N, Dh); positions: (B, S) or (S,)
    ints.  Angles and the rotation in f32; returned in ``x.dtype``."""
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, x.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs           # (B, S, dh/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Token embedding / unembedding
# ---------------------------------------------------------------------------

def init_embedding(generator: torch.Generator, vocab: int, d_model: int,
                   dtype: torch.dtype) -> dict:
    return {"table": embed_init(generator, (vocab, d_model), dtype)}


def shard_offset(x, dim: int) -> int:
    """Where this rank's shard of DTensor ``x``'s dim ``dim`` starts in the
    global tensor (``Shard(dim)`` over several mesh dims nests in mesh
    order, as DTensor splits it)."""
    from repro_torch.launch.sharding import shard_rows
    start, size = 0, x.shape[dim]
    for i, pl in enumerate(x.placements):
        if pl.is_shard(dim):
            lo, hi = shard_rows(size, x.device_mesh.get_local_rank(i),
                                x.device_mesh.size(i))
            start, size = start + lo, hi - lo
    return start


def _scale_rows(h: torch.Tensor, d: int) -> torch.Tensor:
    return h * torch.tensor(math.sqrt(d), dtype=torch.float32,
                            device=h.device).to(h.dtype)


def apply_embedding(p: dict, tokens: torch.Tensor, *,
                    scale: bool = True) -> torch.Tensor:
    """Rows of the table, times ``sqrt(D)`` rounded to the table's dtype as
    the reference rounds it (f32 first: in bf16 sqrt(2560) = 50.596...
    becomes 50.5).

    A table sharded over its rows (a DTensor, the vocab-parallel
    embedding) is looked up on each rank's rows (:func:`_vocab_lookup`);
    the result is a ``Partial`` sum, which the caller constrains (an
    all-reduce)."""
    table = p["table"]
    d = table.shape[-1]
    if is_dtensor(table) and any(pl.is_shard(0) for pl in table.placements):
        return _vocab_lookup(table, tokens, scale)
    h = table[tokens]
    return _scale_rows(h, d) if scale else h


def _vocab_lookup(table, tokens: torch.Tensor, scale: bool):
    """The rows of a row-sharded table, through ``local_map``: each rank
    looks up the ids in its own rows (the others masked to zero rows), so
    the output is ``Partial`` over each mesh dim that shards the rows and
    exactly one rank's term of the sum is nonzero.  Indexing the DTensor
    itself would give DTensor's ``MaskPartial``, which meets the tied
    unembedding's gradient (``Partial``) in the backward and cannot be
    redistributed from it; this way both of the table's gradients are
    ``Shard(0)``."""
    from torch.distributed.tensor import Partial
    start, d = shard_offset(table, 0), table.shape[-1]
    # the rows' mesh dims reduce (Partial); the ids' own sharding (a batch
    # over data) carries over to the rows looked up
    ids_place = tokens.placements if is_dtensor(tokens) else None
    out = [Partial() if pl.is_shard(0) else
           ids_place[i] if ids_place is not None else pl
           for i, pl in enumerate(table.placements)]

    def lookup(local, ids):
        ids = ids.long() - start
        inside = (ids >= 0) & (ids < local.shape[0])
        h = local[torch.where(inside, ids, 0)]
        if scale:
            h = _scale_rows(h, d)
        return torch.where(inside[..., None], h, torch.zeros_like(h))

    return local_apply(lookup, out, table, tokens)


def codebook_lookup(tables, tokens: torch.Tensor):
    """Each codebook's rows of ``tokens`` (..., NC) in the (NC, V, D)
    tables sharded over their vocabulary (a DTensor ``Shard(1)``), stacked
    (..., NC, D) in the tables' dtype, through ``local_map``: each rank
    looks up the ids in its own rows, as :func:`_vocab_lookup` does, so the
    output is ``Partial`` over each mesh dim that shards the vocabulary,
    with exactly one nonzero term a row.  The caller reduces it (one
    all-reduce of every codebook's rows at once).  The tables' gradient
    lands in the holding rank's rows, ``Partial`` over a mesh dim that
    shards the ids' batch."""
    from torch.distributed.tensor import Partial
    start = shard_offset(tables, 1)
    ids_place = tokens.placements if is_dtensor(tokens) else None
    out = [Partial() if pl.is_shard(1) else
           ids_place[i] if ids_place is not None else pl
           for i, pl in enumerate(tables.placements)]
    grad = [Partial() if ids_place is not None and ids_place[i].is_shard()
            else pl for i, pl in enumerate(tables.placements)]

    def lookup(local, ids):
        ids = ids.long() - start
        inside = (ids >= 0) & (ids < local.shape[1])
        safe = torch.where(inside, ids, 0)
        rows = torch.stack([local[c][safe[..., c]]
                            for c in range(local.shape[0])], dim=-2)
        return torch.where(inside[..., None], rows, torch.zeros_like(rows))

    return local_apply(lookup, out, tables, tokens,
                       in_grad_placements=(grad, None))


def apply_unembedding(p: dict, h: torch.Tensor) -> torch.Tensor:
    """Logits against the (tied) table: ``h @ table.T`` in ``h.dtype``."""
    return torch.matmul(h, p["table"].t())


def init_groupnorm(channels: int) -> dict:
    return {"scale": torch.ones((channels,), dtype=torch.float32),
            "bias": torch.zeros((channels,), dtype=torch.float32)}


def group_count(channels: int, groups: int = 8) -> int:
    """The reference's divisor walk: ``min(groups, c)``, decremented until
    it divides ``c``."""
    g = min(groups, channels)
    while channels % g:
        g -= 1
    return g


def apply_groupnorm(p: dict, x: torch.Tensor, groups: int = 8,
                    eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over ``x`` (B, C, H, W): population variance, eps 1e-5,
    per-channel affine — the reference's ``apply_groupnorm`` on NCHW.

    ``F.group_norm`` is PyTorch's fused GroupNorm.  Its f32 backward is
    less exact than JAX's on tiny groups (about 1e-5 absolute error on
    groups of 2 values, where JAX's is 5e-7); the model's smallest groups
    at 32x32 inputs hold 1,024 values, and the parity tests use 16x16
    inputs (groups of 8 or more) for that reason."""
    g = group_count(x.shape[1], groups)
    return F.group_norm(x.float(), g, p["scale"].float(), p["bias"].float(),
                        eps).to(x.dtype)


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-position NLL in f32, in the reference's formula: the max taken
    without gradient, ``logits - max`` in the logits' dtype and only then
    widened, the gold logit picked in the logits' dtype.  The reference
    picks it as ``sum(logits * one_hot)``; every other term of that sum is
    an exact zero, so ``gather`` gives the same value and gradient without
    a ``(..., V)`` one-hot (0.5 GB a head at Gemma-2's vocab).

    Logits sharded over the vocabulary (a DTensor) take the same formula
    vocab-parallel: the max and the sum of exponentials are reduced over
    the ranks (all-reduces of one value a position; the sum in another
    order than one rank's), the gold logit is picked on the rank that holds
    it (:func:`_gold_logit`); the logits are never gathered."""
    m = logits.amax(dim=-1, keepdim=True).detach()
    sharded = is_dtensor(logits) and any(
        p.is_shard(logits.dim() - 1) for p in logits.placements)
    if sharded:
        m = reduce_partial(m)        # Partial(max) -> an all-reduce
    shifted = (logits - m).float()
    total = torch.sum(torch.exp(shifted), dim=-1)
    if sharded:
        total = reduce_partial(total)    # an all-reduce, never a scatter
        gold = _gold_logit(logits, labels)
    else:
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.log(total) + m[..., 0].float() - gold.float()


def _gold_logit(logits, labels: torch.Tensor) -> torch.Tensor:
    """``logits[..., labels]`` of vocab-sharded logits, through
    ``local_map``: each rank picks the labels in its own vocab range (the
    others zero), so the result is a ``Partial`` sum with one nonzero
    term, and its gradient lands in the holding rank's shard."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    last = logits.dim() - 1
    start = shard_offset(logits, last)
    out = [Partial() if pl.is_shard(last) else pl for pl in logits.placements]
    if not is_dtensor(labels):
        # plain labels are the global batch: take the rows the logits hold
        # (a batch sharded over data), as the logits' other placements say
        mesh = logits.device_mesh
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False).redistribute(
            mesh, [Replicate() if pl.is_shard(last) else pl
                   for pl in logits.placements])

    def pick(local, lab):
        ids = lab.long() - start
        inside = (ids >= 0) & (ids < local.shape[-1])
        g = torch.gather(local, -1, torch.where(inside, ids, 0)[..., None])
        return torch.where(inside, g[..., 0], torch.zeros_like(g[..., 0]))

    return reduce_partial(local_apply(pick, out, logits, labels))


def codebook_cross_entropy_sum(logits: torch.Tensor,
                               labels: torch.Tensor) -> torch.Tensor:
    """The codebooks' NLL sums added in order, in f32: logits (..., NC,
    V), labels (..., NC).

    Logits sharded over their codebook dim (a DTensor) are summed on each
    rank's codebooks over the whole vocabulary, through ``local_map``: a
    ``Partial`` sum over the mesh dims that shard the codebooks (and over
    those that shard the batch), whose codebook dims are reduced here (an
    all-reduce), so that it holds the sum of every codebook.  The ranks'
    sums are added in another order than one rank's."""
    cdim = logits.dim() - 2
    cdims = sharding_dims(logits, cdim)
    if not cdims:
        total = softmax_cross_entropy_sum(logits[..., 0, :], labels[..., 0])
        for c in range(1, logits.shape[cdim]):
            total = total + softmax_cross_entropy_sum(logits[..., c, :],
                                                      labels[..., c])
        return total
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = logits.device_mesh
    if not is_dtensor(labels):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    # the labels placed as the logits' leading dims (no collective: the
    # logits are never sharded on their vocabulary here)
    labels = labels.redistribute(mesh, [
        pl if pl.is_shard() else Replicate() for pl in logits.placements])
    out = [Partial() if pl.is_shard() else pl for pl in logits.placements]

    def nll(local, lab):
        return codebook_cross_entropy_sum(local, lab)

    total = local_apply(nll, out, logits, labels)
    return total.redistribute(mesh, [
        Replicate() if i in cdims else pl
        for i, pl in enumerate(total.placements)])


def reduce_partial(x):
    """A DTensor's ``Partial`` placements reduced (all-reduces), the
    others kept."""
    from torch.distributed.tensor import Replicate
    place = [Replicate() if p.is_partial() else p for p in x.placements]
    return x.redistribute(x.device_mesh, place)


def softmax_cross_entropy_sum(logits: torch.Tensor,
                              labels: torch.Tensor) -> torch.Tensor:
    """Sum (not mean) of the per-position NLL of integer ``labels`` under
    ``logits`` (..., V), in f32."""
    return torch.sum(_nll(logits, labels))


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Mean NLL over the (optionally ``mask``ed) positions, in f32."""
    nll = _nll(logits, labels)
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)
