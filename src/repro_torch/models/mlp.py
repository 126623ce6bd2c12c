"""Dense GLU MLP and Mixture-of-Experts layers: the port of
``repro.models.mlp``.

MoE uses capacity-based top-k routing with a routing group per batch row
(a sequence in training and prefill; decode routes the whole batch as one
group): each group's tokens go into an ``(E, C, D)`` buffer by a gather
from ``x`` with a zero row appended (the garbage index ``S`` reads it), the
experts run as one batched product over ``E``, and each token adds its
experts' gated outputs back.  A (token, choice) pair past its expert's
capacity ``C`` is dropped, as in Switch/GShard.  Both layers take the
reference's ``policy`` and constrain at its sites.

**Over a live model axis** (the weights DTensors placed by
``launch/sharding.param_specs``) the MoE block runs as GSPMD runs the
reference's.  The f32 router's logits are a DTensor product (``x`` and the
router replicated over ``model``), so every model rank routes the same
tokens.  Routing, dispatch, the expert products and the combine then run
on each rank's local tensors in one ``common.local_apply``
(:func:`_moe_local`): DTensor has no sharding rule for ``searchsorted``,
the stable sorts or the indexed gathers, and where it lacks one it
replicates.  With the experts axis over ``model`` each rank takes its
experts' rows of the routing buffers, runs its ``(E/m, D, F)`` products and
combines only the slots it owns (every other choice reads the appended
zero row); with ``expert_ffn`` over ``model`` (E does not divide the axis)
the gate and up products are column-parallel and ``down`` row-parallel.
Either way the combined output is a ``Partial`` sum over ``model``, which
the reference's ``("batch", "seq", None)`` constrain reduces; across ranks
the sum takes another order than one rank's combine, so sharded and
unsharded agree at a tolerance.  kimi-k2's 2-D experts (``expert_ffn``
also over ``data``) are gathered over ``data`` where the batch is sharded
there, as GSPMD gathers an FSDP weight (one all-reduce each way,
``common.redistribute_by_sum``); where it is not (a batch of one row, or
decode, whose few rows are gathered instead: one all-reduce) each data
rank runs its ``expert_ffn`` slice and the slices' sum is reduced over
``data``.  The aux losses are computed on each rank's rows of the router
logits, their sums reduced over a sharded batch in one all-reduce:
``load_balance`` is a product of two batch means, each reduced before the
product.

**A routing group split across ranks** (a token split's sequence, or
decode's one group over a batch sharded over data or data x model) routes
as the reference's one global computation does: the capacity comes from
the group's whole token count, and a pair's place in its expert's queue is
the count of the pairs before it in the whole group -- this rank's running
count plus the group's offset, the pairs of the ranks before it that chose
that expert (:class:`RoutingGroup`: one all-reduce of every rank's counts,
then an exclusive prefix in the ranks' order).  Each rank dispatches only
its own pairs, into ``min(C, S_local)`` slots an expert (a pair's slot is
its local queue place, kept while the global one is under ``C``), and
combines them in the same ascending (expert, slot) order; no rank gathers
another's tokens (but decode's, where the experts are split over a dim
that splits the batch: above).  The aux losses are the whole batch's means:
each rank's sums reduced over the mesh dims that split the tokens (one
all-reduce) before the means and the product.

Where a faithful-looking port could part from the reference, this one
follows it exactly:

* top-k ties go to the lower expert index, as ``lax.top_k`` breaks them
  (a stable descending sort; ``torch.topk`` promises no order);
* a pair's place in its expert's queue is an exclusive running count over
  the group's (token, choice) pairs flattened token-major, so capacity
  drops the same pairs;
* the combine multiplies by the gate and adds in ``y``'s dtype, each
  token's contributions in ascending (expert, slot) order from a zero
  start: the reference's scatter-add, one rounding an add.  It is a
  gather, not ``index_add_``, whose atomics on CUDA add in no fixed order.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models import common
from repro_torch.models.common import NO_POLICY, Policy


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (``F.gelu``'s
    default is the exact erf form)."""
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# Dense GLU MLP (gate, up, down)
# ---------------------------------------------------------------------------

def init_mlp(generator: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None) -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    dt = cfg.torch_param_dtype()
    p = {"up": common.dense_init(generator, (d, f), dtype=dt),
         "down": common.dense_init(generator, (f, d), fan_in=f, dtype=dt)}
    if cfg.mlp_glu:
        p["gate"] = common.dense_init(generator, (d, f), dtype=dt)
    return p


def apply_mlp(p: dict, x: torch.Tensor,
              policy: Policy = NO_POLICY) -> torch.Tensor:
    """x (..., D) -> (..., D) in ``x.dtype``.  The hidden is constrained
    to ``("batch", "seq", "ffn")`` (the reference's site): over a model
    axis the up and gate projections are column-parallel and the down
    projection row-parallel, so the output is a ``Partial`` sum that the
    caller reduces."""
    u = torch.matmul(x, p["up"].to(x.dtype))
    if "gate" in p:
        h = gelu(torch.matmul(x, p["gate"].to(x.dtype))) * u
    else:
        h = gelu(u)
    h = policy.constrain(h, ("batch", "seq", "ffn"))
    return torch.matmul(h, p["down"].to(x.dtype))


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------

def padded_experts(moe: MoEConfig) -> int:
    """The expert axis of the weights and the routing buffers: ``pad_to``
    when it is set and above ``n_experts``.  The router spans the real
    experts only, so pad experts never receive a token."""
    return max(moe.pad_to, moe.n_experts) if moe.pad_to else moe.n_experts


def _init_experts(generator: torch.Generator, shape, fan_in: int,
                  dtype: torch.dtype) -> torch.Tensor:
    """A stacked expert leaf, drawn one expert at a time straight into
    ``dtype``: kimi-k2's (384, 7168, 2048) leaf is 5.6 G elements, and one
    f32 draw of it would need 22.5 GB beside its 11.3 GB bf16 copy."""
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    if out.is_meta:
        return out
    for i in range(shape[0]):
        out[i] = common.dense_init(generator, shape[1:], fan_in=fan_in,
                                   dtype=dtype)
    return out


def init_moe(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """``router`` (D, n_experts) in f32 whatever the param dtype;
    ``experts`` gate / up (E_pad, D, d_expert) and down (E_pad, d_expert,
    D); ``shared``, a list of ``n_shared`` dense MLPs at ``d_expert``."""
    m = cfg.moe
    d = cfg.d_model
    de = m.d_expert or cfg.d_ff
    dt = cfg.torch_param_dtype()
    e = padded_experts(m)
    p = {"router": common.dense_init(generator, (d, m.n_experts),
                                     dtype=torch.float32),
         "experts": {
             "gate": _init_experts(generator, (e, d, de), d, dt),
             "up": _init_experts(generator, (e, d, de), d, dt),
             "down": _init_experts(generator, (e, de, d), de, dt)}}
    if m.n_shared:
        p["shared"] = [init_mlp(generator, cfg, d_ff=de)
                       for _ in range(m.n_shared)]
    return p


def _capacity(moe: MoEConfig, tokens_per_group: int) -> int:
    """Slots an expert has in a group: ``int(top_k * tokens *
    capacity_factor / n_experts)`` in Python floats, within [1, tokens]."""
    c = int(moe.top_k * tokens_per_group * moe.capacity_factor
            / moe.n_experts)
    return max(min(c, tokens_per_group), 1)


def _topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of the last axis and their indices, in
    descending order, ties toward the lower index (``lax.top_k``'s rule,
    by a stable descending sort).  Gradients reach the picked entries."""
    idx = torch.sort(x.detach(), dim=-1, descending=True,
                     stable=True).indices[..., :k]
    return torch.gather(x, -1, idx), idx


class Routing(NamedTuple):
    # C slots an expert, min(C, S) on a rank's part of a split group
    slot_idx: torch.Tensor      # (B, E_pad, C) token a slot takes; S = none
    slot_gate: torch.Tensor     # (B, E_pad, C) f32 combine weight; 0 = none
    token_expert: torch.Tensor  # (B, S, K) the experts a token chose
    token_slot: torch.Tensor    # (B, S, K) e * C + slot, E_pad * C if dropped
    probs: torch.Tensor         # (B, S, E) f32 softmax of the router logits


class RoutingGroup(NamedTuple):
    """Where a layer's routing groups lie across ranks (module docstring):
    ``dims``, the mesh dims that split each group's tokens, nested in mesh
    order as DTensor splits them, and ``tokens``, a group's whole token
    count."""
    mesh: Any
    dims: tuple
    tokens: int

    def place(self) -> int:
        """This rank's place among the group's ranks: its local ranks
        along ``dims``, outermost first (however the ranks' rows are
        sized)."""
        index = 0
        for i in self.dims:
            index = index * self.mesh.size(i) + self.mesh.get_local_rank(i)
        return index


def _queue_offsets(counts: torch.Tensor, group: RoutingGroup
                   ) -> torch.Tensor:
    """(B, E) f32 counts of this rank's pairs by expert -> (B, E) int64:
    the pairs of the ranks before this one in the group that chose each
    expert.  Every rank's counts are gathered by one sum
    (``common.gather_by_sum``; integers below 2^24 are exact in f32) and
    the ranks before this one (:meth:`RoutingGroup.place`) added."""
    n, index = 1, group.place()
    for i in group.dims:
        n *= group.mesh.size(i)
    every = common.gather_by_sum(counts[None], 0, index, n, group.mesh,
                                 group.dims)
    return every[:index].sum(0).long()


def _route(router_logits: torch.Tensor, moe: MoEConfig, capacity: int,
           e_pad: int = 0, group: Optional[RoutingGroup] = None) -> Routing:
    """:func:`route_topk`'s routing; with ``group`` the tokens are this
    rank's part of each group (module docstring): a pair is kept where its
    place in the whole group's queue is under ``capacity``, and goes to
    its local place among ``min(capacity, S)`` slots of its expert."""
    b, s, e = router_logits.shape
    k = moe.top_k
    e_out = max(e_pad, e)
    dev = router_logits.device
    probs = torch.softmax(router_logits.float(), dim=-1)

    topk_prob, topk_idx = _topk(probs, k)                     # (B, S, K)
    # normalize the combine weights over the selected experts
    topk_prob = topk_prob / torch.clamp_min(
        torch.sum(topk_prob, dim=-1, keepdim=True), 1e-9)

    # place of each (token, choice) in its expert's queue: the count of
    # the pairs before it, flattened token-major, that chose its expert
    # (the reference's exclusive cumsum of one-hots, here by a stable sort
    # of the pairs by expert: the one-hot scan over (S * K, E) took half
    # of qwen2-moe's prefill on the card)
    flat_e = topk_idx.reshape(b, s * k)
    order = torch.sort(flat_e, dim=1, stable=True).indices
    grouped = torch.gather(flat_e, 1, order)                  # by expert
    first = torch.searchsorted(grouped, grouped)              # run starts
    rank = torch.empty_like(flat_e).scatter_(
        1, order, torch.arange(s * k, device=dev) - first)
    slots = capacity
    if group is not None and group.dims:
        # the place in the whole group's queue: the ranks before this one
        # first
        counts = torch.zeros((b, e), device=dev).scatter_add_(
            1, flat_e, torch.ones(flat_e.shape, device=dev))
        offset = torch.gather(_queue_offsets(counts, group), 1, flat_e)
        within = offset + rank < capacity                     # (B, S * K)
        slots = min(capacity, s)
    else:
        within = rank < capacity

    # scatter token indices and gates into (B, E_pad, C) slots; a dropped
    # pair goes to a spare slot of its own past the buffer, sliced off
    n_slots = e_out * slots
    spare = n_slots + torch.arange(s * k, device=dev)
    pos = torch.where(within, flat_e * slots + rank, spare)
    tok = torch.arange(s, device=dev).repeat_interleave(k).expand(b, -1)
    slot_idx = torch.full((b, n_slots + s * k), s, dtype=torch.long,
                          device=dev).scatter_(1, pos, tok)
    gates = torch.where(within, topk_prob.reshape(b, s * k),
                        torch.zeros((), device=dev))
    slot_gate = torch.zeros((b, n_slots + s * k), device=dev).scatter(
        1, pos, gates)
    slot_idx = slot_idx[:, :n_slots].reshape(b, e_out, slots)
    slot_gate = slot_gate[:, :n_slots].reshape(b, e_out, slots)
    token_slot = torch.where(within, pos, n_slots).reshape(b, s, k)
    return Routing(slot_idx, slot_gate, topk_idx, token_slot, probs)


def _aux_losses(logits: torch.Tensor, probs: torch.Tensor,
                first: torch.Tensor, moe: MoEConfig, mesh=None, dims=(),
                total: Optional[int] = None) -> dict:
    """The Switch-style aux losses of the whole batch from this rank's
    tokens (``logits`` and their softmax ``probs`` (B, S, E) f32, ``first``
    (B, S) each token's first choice): the sums of the probabilities, of
    the first choices and of the squared log-sum-exps, reduced over the
    mesh dims ``dims`` that split the tokens in one all-reduce
    (``common.GatherBySum``, whose backward is the identity: every rank
    uses the sums alike), each divided by ``total``, the whole token count
    (this rank's where nothing splits them).  ``load_balance`` is ``E *
    sum(me * ce)``, the product of the two whole-batch means: a mean of
    per-rank products would be another loss.  The same value on every
    rank.  Routing groups do not enter: each token's choices are its
    own."""
    e = logits.shape[-1]
    dev = logits.device
    counts = torch.zeros(e, device=dev).scatter_add_(
        0, first.reshape(-1), torch.ones(first.numel(), device=dev))
    lse = torch.sum(torch.square(torch.logsumexp(logits.float(), dim=-1)))
    sums = torch.cat([torch.sum(probs, dim=(0, 1)), counts, lse[None]])
    if dims:
        sums = common.GatherBySum.apply(sums, 0, 0, 2 * e + 1, mesh, dims,
                                        [])
    sums = sums / (first.numel() if total is None else total)
    load_balance = e * torch.sum(sums[:e] * sums[e:2 * e])
    return {"load_balance": load_balance * moe.load_balance_loss,
            "router_z": sums[2 * e] * moe.router_z_loss}


def _sharded_aux_losses(logits, first, moe: MoEConfig) -> dict:
    """The aux losses of DTensor router logits (B, S, E), the experts axis
    whole on each rank, and the routing's first choices ``first`` (B, S),
    placed like them: :func:`_aux_losses` on each rank's tokens through
    ``common.local_apply`` (one all-reduce where the batch is sharded),
    replicated.  It takes its own softmax of the logits: the routing's
    gradient reaches them ``Partial`` over the dims that shard the experts
    (each rank's experts add their terms), the aux's placed like them
    (ranks that hold the same rows take the same terms)."""
    from torch.distributed.tensor import Replicate
    mesh = logits.device_mesh
    dims = tuple(i for i, pl in enumerate(logits.placements)
                 if pl.is_shard() and mesh.size(i) > 1)
    total = logits.shape[0] * logits.shape[1]

    def aux(ll, fl):
        a = _aux_losses(ll, torch.softmax(ll, dim=-1), fl, moe, mesh, dims,
                        total)
        return a["load_balance"], a["router_z"]
    whole = [Replicate()] * mesh.ndim
    lb, z = common.local_apply(aux, (whole, whole), logits, first)
    return {"load_balance": lb, "router_z": z}


def route_topk(router_logits: torch.Tensor, moe: MoEConfig, capacity: int,
               e_pad: int = 0):
    """Top-k routing with per-group capacity.

    router_logits: (B, S, E).  Returns
      slot_idx  (B, E_pad, C) token index per expert slot (S = garbage),
      slot_gate (B, E_pad, C) f32 combine weight per slot (0 for empty),
      token_expert (B, S, K) chosen experts per token (diagnostics),
      aux: router z-loss and load-balance loss terms.
    Indices are int64, torch's index dtype (the reference's are int32)."""
    r = _route(router_logits, moe, capacity, e_pad)
    return r.slot_idx, r.slot_gate, r.token_expert, _aux_losses(
        router_logits, r.probs, r.token_expert[..., 0], moe)


def _expert_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, E, C, K) x (E, K, N) -> (B, E, C, N): the reference's einsum
    ``becd,edf->becf`` as one batched product over the experts (a view of
    ``x`` when B is 1; the weights are never copied)."""
    b, e, c, k = x.shape
    y = torch.bmm(x.transpose(0, 1).reshape(e, b * c, k), w)
    return y.reshape(e, b, c, -1).transpose(0, 1)


def _combine(y: torch.Tensor, token_slot: torch.Tensor) -> torch.Tensor:
    """y (B, E, C, D), gated -> (B, S, D) in ``y.dtype``: each token adds
    its slots' rows to a zero start, in ascending (expert, slot) order, one
    rounding an add, as the reference's scatter-add applies its updates.
    A dropped choice reads an appended zero row (adding +0 leaves the sum
    bitwise as it was; the sum never is -0)."""
    b, e, c, d = y.shape
    flat = torch.cat([y.reshape(b, e * c, d),
                      y.new_zeros((b, 1, d))], dim=1)
    order = torch.sort(token_slot, dim=-1).values             # (B, S, K)
    vals = flat[torch.arange(b, device=y.device)[:, None, None], order]
    out = torch.zeros(vals.shape[:2] + (d,), dtype=y.dtype, device=y.device)
    for i in range(vals.shape[2]):
        out = out + vals[:, :, i]
    return out


def _moe_local(x: torch.Tensor, logits: torch.Tensor, gate: torch.Tensor,
               up: torch.Tensor, down: torch.Tensor, moe: MoEConfig,
               e_pad: int, lo: int, policy: Policy = NO_POLICY,
               group: Optional[RoutingGroup] = None):
    """The MoE block's routed half on local tensors: route ``logits`` (B, S,
    E) f32, dispatch ``x`` (B, S, D) to experts ``[lo, lo + el)`` (the
    ``el`` experts of ``gate`` / ``up`` (el, D, F) and ``down`` (el, F,
    D), all of them when ``lo`` is 0 and ``el`` is ``e_pad``), run their
    products and combine their gated outputs.  Returns ``(out (B, S, D) in
    x's dtype, the Routing)``; ``out`` holds only these
    experts' terms, each token's in ascending (expert, slot) order, the
    choices of other experts and the dropped ones reading the appended zero
    row.  ``policy`` constrains the dispatch buffer and the hidden (the
    reference's sites; the identity on local tensors).  With ``group`` the
    tokens are this rank's part of each routing group (module docstring),
    and the capacity is the whole group's."""
    b, s, d = x.shape
    capacity = _capacity(moe, s if group is None else group.tokens)
    r = _route(logits, moe, capacity, e_pad, group)
    el = gate.shape[0]
    slots = r.slot_idx.shape[-1]
    slot_idx = r.slot_idx[:, lo:lo + el]
    slot_gate = r.slot_gate[:, lo:lo + el]

    # dispatch: gather tokens into (B, E, C, D); garbage index S reads zeros
    xp = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)
    dispatched = xp[torch.arange(b, device=x.device)[:, None, None],
                    slot_idx]
    dispatched = policy.constrain(dispatched, ("batch", "experts", None,
                                               None))

    g = _expert_matmul(dispatched, gate.to(x.dtype))
    u = _expert_matmul(dispatched, up.to(x.dtype))
    h = policy.constrain(gelu(g) * u, ("batch", "experts", None,
                                       "expert_ffn"))
    y = _expert_matmul(h, down.to(x.dtype))

    # combine, weighted by the gate in y's dtype; a slot of another expert
    # (or a dropped choice) reads the zero row past this block's slots
    y = y * slot_gate[..., None].to(y.dtype)
    token_slot = r.token_slot
    if el != e_pad:
        first = lo * slots
        mine = (token_slot >= first) & (token_slot < first + el * slots)
        token_slot = torch.where(mine, token_slot - first, el * slots)
    return _combine(y, token_slot), r


def _split_group(policy: Policy) -> Optional[RoutingGroup]:
    """The :class:`RoutingGroup` of a token split's block (``policy`` a
    ``common.TokenSplit``): each sequence a group, split over the dims
    that split the sequence.  ``None`` where the sequence is whole on the
    rank."""
    if not isinstance(policy, common.TokenSplit) or not policy.dims:
        return None
    return RoutingGroup(policy.mesh, tuple(policy.dims), policy.size)


def _split_aux(policy: Policy, x: torch.Tensor) -> tuple:
    """``(mesh, dims, total)`` of :func:`_aux_losses` on this rank's tokens
    ``x`` (B, S, D): in a token split's block the mesh dims that split the
    batch or the sequence and the whole token count; else none, and this
    rank's count."""
    if isinstance(policy, common.TokenSplit):
        return (policy.mesh, tuple(sorted(policy.batch_dims + policy.dims)),
                policy.batch * policy.size)
    return None, (), x.shape[0] * x.shape[1]


def _apply_moe_sharded(p: dict, x: torch.Tensor, logits: torch.Tensor,
                       moe: MoEConfig, e_pad: int, one_group: bool = False):
    """The routed half over a live mesh (module docstring), on each rank's
    shards through ``common.local_apply``: :func:`_moe_local` with each
    rank's experts.  Returns ``(out, first)``: ``out`` is ``Partial`` over
    each mesh dim that shards the experts but not the batch, and placed
    like ``x`` elsewhere; ``first``, each token's first choice, placed like
    ``x`` (:func:`_sharded_aux_losses`).

    Where a mesh dim shards both the batch and the experts (kimi-k2's 2-D
    experts, ``expert_ffn`` over ``data``) the experts are gathered over it,
    as GSPMD gathers an FSDP weight (one all-reduce each way, ``common.
    redistribute_by_sum``), and a weight's gradient is ``Partial`` there
    (each rank's tokens add theirs).  ``one_group``: the whole batch is one
    routing group (decode).  Where the batch is sharded each rank routes
    its rows with the queue offsets of the ranks before it; but where a dim
    that shards the batch shards the experts too, the batch's rows are
    gathered instead (one all-reduce each of ``x`` and the logits, the
    reference's reshape), the whole group routed on every rank, each data
    rank's ``expert_ffn`` slice run as where the batch is whole, and the
    slices' sum reduced over those dims (one all-reduce) before each rank
    keeps its rows: a decode step's rows are far smaller than the experts.
    The gradients of ``x`` and of the logits are ``Partial`` over the dims
    that shard the experts (each rank's experts add their terms); decode
    takes none."""
    from torch.distributed.tensor import Partial, Replicate
    w = p["experts"]
    experts = (w["gate"], w["up"], w["down"])
    mesh = experts[0].device_mesh
    x_place = list(x.placements)
    batch = [i for i, pl in enumerate(x_place)
             if pl.is_shard() and mesh.size(i) > 1]
    both = [i for i in batch
            if any(wt.placements[i].is_shard() for wt in experts)]
    gather_rows = one_group and bool(both)
    weights = list(experts) if gather_rows else [
        common.redistribute_by_sum(wt, [
            Replicate() if i in batch else pl
            for i, pl in enumerate(wt.placements)]) for wt in experts]
    out_place = [Partial() if weights[0].placements[i].is_shard()
                 and i not in batch else pl for i, pl in enumerate(x_place)]
    w_grads = [[Partial() if x_place[i].is_shard() else pl
                for i, pl in enumerate(wt.placements)] for wt in weights]
    lo = common.shard_offset(weights[0], 0)
    group = None
    if one_group and batch and not gather_rows:
        group = RoutingGroup(mesh, tuple(batch), x.shape[0] * x.shape[1])
    rows = common.held_rows(x.shape[0], mesh, batch)

    def routed(xl, ll, gl, ul, dl):
        b, s, d = xl.shape
        if gather_rows:
            args = (0, rows[0], x.shape[0], mesh, batch)
            xl = common.gather_by_sum(xl, *args)
            ll = common.gather_by_sum(ll, *args)
        if one_group:
            xl = xl.reshape(1, -1, d)
            ll = ll.reshape(1, xl.shape[1], -1)
        out, r = _moe_local(xl, ll, gl, ul, dl, moe, e_pad, lo, group=group)
        out = out.reshape(-1, s, d)
        first = r.token_expert[..., 0].reshape(-1, s)
        if gather_rows:
            out = common.all_reduce(out, "sum", mesh, both)
            out, first = out[rows[0]:rows[1]], first[rows[0]:rows[1]]
        return out, first

    return common.local_apply(
        routed, (out_place, x_place), x, logits, *weights,
        in_grad_placements=(out_place, out_place, *w_grads))


def apply_moe(p: dict, x: torch.Tensor, cfg: ModelConfig,
              policy: Policy = NO_POLICY, *, one_group: bool = False
              ) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, D) -> (out in ``x.dtype``, aux losses); each row of the
    batch is a routing group, or with ``one_group`` the whole batch is one
    (decode: the reference's ``x.reshape(1, B * S, D)``).  ``policy``
    constrains the dispatch buffer, the expert hidden and the combined
    output (the reference's sites); on DTensors the routed half runs on
    each rank's shards, and in a token split's block on this rank's
    tokens of each group (module docstring)."""
    m = cfg.moe
    e_pad = padded_experts(m)
    w = p["experts"]
    sharded = common.is_dtensor(w["gate"])
    if one_group and not sharded:
        b, s, d = x.shape
        y, aux = apply_moe(p, x.reshape(1, b * s, d), cfg, policy)
        return y.reshape(b, s, d), aux
    logits = torch.matmul(x.float(), p["router"])
    if sharded:
        out, first = _apply_moe_sharded(p, x, logits, m, e_pad, one_group)
        aux = _sharded_aux_losses(logits, first, m)
    else:
        out, r = _moe_local(x, logits, w["gate"], w["up"], w["down"], m,
                            e_pad, 0, policy, _split_group(policy))
        aux = _aux_losses(logits, r.probs, r.token_expert[..., 0], m,
                          *_split_aux(policy, x))
    out = policy.constrain(out, ("batch", "seq", None))
    shared = [apply_mlp(sp, x, policy) for sp in p.get("shared", [])]
    if sharded and shared:
        # the shared experts' Partial sums added on each rank first, then
        # reduced once (DTensor would all-reduce each at its add)
        total = shared[0]
        for y in shared[1:]:
            total = total + y
        shared = [policy.constrain(total, ("batch", "seq", None))]
    for y in shared:
        out = out + y
    return out, aux
