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
there, as GSPMD gathers an FSDP weight; where it is not (decode routes the
batch as one group) each data rank runs its ``expert_ffn`` slice and the
output is ``Partial`` over ``data`` too.  The aux losses are computed on
the DTensor logits:
``load_balance`` is a product of two batch means, each reduced over a
data-sharded batch before the product.

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

from typing import NamedTuple, Optional, Tuple

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
    slot_idx: torch.Tensor      # (B, E_pad, C) token a slot takes; S = none
    slot_gate: torch.Tensor     # (B, E_pad, C) f32 combine weight; 0 = none
    token_expert: torch.Tensor  # (B, S, K) the experts a token chose
    token_slot: torch.Tensor    # (B, S, K) e * C + slot, E_pad * C if dropped
    aux: dict


def _route(router_logits: torch.Tensor, moe: MoEConfig, capacity: int,
           e_pad: int = 0) -> Routing:
    b, s, e = router_logits.shape
    k = moe.top_k
    e_out = max(e_pad, e)
    dev = router_logits.device
    logits = router_logits.float()
    probs = torch.softmax(logits, dim=-1)

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
    within = rank < capacity                                  # (B, S * K)

    # scatter token indices and gates into (B, E_pad, C) slots; a dropped
    # pair goes to a spare slot of its own past the buffer, sliced off
    n_slots = e_out * capacity
    spare = n_slots + torch.arange(s * k, device=dev)
    pos = torch.where(within, flat_e * capacity + rank, spare)
    tok = torch.arange(s, device=dev).repeat_interleave(k).expand(b, -1)
    slot_idx = torch.full((b, n_slots + s * k), s, dtype=torch.long,
                          device=dev).scatter_(1, pos, tok)
    gates = torch.where(within, topk_prob.reshape(b, s * k),
                        torch.zeros((), device=dev))
    slot_gate = torch.zeros((b, n_slots + s * k), device=dev).scatter(
        1, pos, gates)
    slot_idx = slot_idx[:, :n_slots].reshape(b, e_out, capacity)
    slot_gate = slot_gate[:, :n_slots].reshape(b, e_out, capacity)
    token_slot = torch.where(within, pos, n_slots).reshape(b, s, k)

    aux = _aux_losses(logits, probs, _first_choice_share(topk_idx, e), moe)
    return Routing(slot_idx, slot_gate, topk_idx, token_slot, aux)


def _first_choice_share(topk_idx: torch.Tensor, e: int) -> torch.Tensor:
    """(B, S, K) choices -> (B, E): the share of each group's tokens whose
    first choice is each expert."""
    b, s = topk_idx.shape[:2]
    dev = topk_idx.device
    counts = torch.zeros((b, e), device=dev).scatter_add_(
        1, topk_idx[..., 0], torch.ones((b, s), device=dev))
    return counts / s


def _aux_losses(logits: torch.Tensor, probs: torch.Tensor,
                share: torch.Tensor, moe: MoEConfig) -> dict:
    """The Switch-style aux losses of f32 router logits (B, S, E), their
    softmax and :func:`_first_choice_share`.  ``load_balance`` is ``E *
    sum(me * ce)``, a product of two batch means: on DTensors whose batch
    is sharded over data each mean is a ``Partial`` average, reduced before
    the product (a mean of per-rank products would be another loss)."""
    e = logits.shape[-1]
    me = torch.mean(probs, dim=(0, 1))                        # (E,)
    ce = torch.mean(share, dim=0)
    load_balance = e * torch.sum(me * ce)
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return {"load_balance": load_balance * moe.load_balance_loss,
            "router_z": z_loss * moe.router_z_loss}


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
    return r.slot_idx, r.slot_gate, r.token_expert, r.aux


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
               e_pad: int, lo: int, policy: Policy = NO_POLICY):
    """The MoE block's routed half on local tensors: route ``logits`` (B, S,
    E) f32, dispatch ``x`` (B, S, D) to experts ``[lo, lo + el)`` (the
    ``el`` experts of ``gate`` / ``up`` (el, D, F) and ``down`` (el, F,
    D), all of them when ``lo`` is 0 and ``el`` is ``e_pad``), run their
    products and combine their gated outputs.  Returns ``(out (B, S, D) in
    x's dtype, the Routing)``; ``out`` holds only these
    experts' terms, each token's in ascending (expert, slot) order, the
    choices of other experts and the dropped ones reading the appended zero
    row.  ``policy`` constrains the dispatch buffer and the hidden (the
    reference's sites; the identity on local tensors)."""
    b, s, d = x.shape
    capacity = _capacity(moe, s)
    r = _route(logits, moe, capacity, e_pad)
    el = gate.shape[0]
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
        first = lo * capacity
        mine = (token_slot >= first) & (token_slot < first + el * capacity)
        token_slot = torch.where(mine, token_slot - first, el * capacity)
    return _combine(y, token_slot), r


def _apply_moe_sharded(p: dict, x: torch.Tensor, logits: torch.Tensor,
                       moe: MoEConfig, e_pad: int):
    """The routed half over a live mesh (module docstring): the expert
    weights gathered over each mesh dim that shards the batch too
    (kimi-k2's 2-D layout in training and prefill, as GSPMD gathers an
    FSDP weight; a dim of size 1 needs no gather), then :func:`_moe_local`
    on each rank's shards through ``common.local_apply``.  Returns ``(out,
    first-choice share)``: ``out`` is ``Partial`` over each mesh dim that
    still shards the experts (a 2-D layout's data dim where the batch is
    whole there, as decode's one routing group is: each data rank runs its
    expert_ffn slice) and placed like ``x`` elsewhere, the share placed
    like ``x``.  The gradients of ``x`` and of the logits are ``Partial``
    over the dims that shard the experts too (each rank's experts add
    their terms), and a weight's is ``Partial`` over a dim that shards the
    batch (each rank's tokens add theirs)."""
    from torch.distributed.tensor import Partial, Replicate
    w = p["experts"]
    mesh = w["gate"].device_mesh
    x_place = list(x.placements)
    batch = [i for i, pl in enumerate(x_place)
             if pl.is_shard() and mesh.size(i) > 1]
    weights = [wt.redistribute(mesh, [Replicate() if i in batch else pl
                                      for i, pl in enumerate(wt.placements)])
               if any(wt.placements[i].is_shard() for i in batch) else wt
               for wt in (w["gate"], w["up"], w["down"])]
    out_place = [Partial() if weights[0].placements[i].is_shard() else pl
                 for i, pl in enumerate(x_place)]
    w_grads = [[Partial() if x_place[i].is_shard() else pl
                for i, pl in enumerate(wt.placements)] for wt in weights]
    lo = common.shard_offset(weights[0], 0)

    def routed(xl, ll, gl, ul, dl):
        out, r = _moe_local(xl, ll, gl, ul, dl, moe, e_pad, lo)
        return out, _first_choice_share(r.token_expert, ll.shape[-1])

    return common.local_apply(
        routed, (out_place, x_place), x, logits, *weights,
        in_grad_placements=(out_place, out_place, *w_grads))


def apply_moe(p: dict, x: torch.Tensor, cfg: ModelConfig,
              policy: Policy = NO_POLICY) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, D) -> (out in ``x.dtype``, aux losses); each row of the
    batch is a routing group.  ``policy`` constrains the dispatch buffer,
    the expert hidden and the combined output (the reference's sites); on
    DTensors the routed half runs on each rank's shards (module
    docstring)."""
    m = cfg.moe
    e_pad = padded_experts(m)
    w = p["experts"]
    sharded = common.is_dtensor(w["gate"])
    logits = torch.matmul(x.float(), p["router"])
    if sharded:
        out, share = _apply_moe_sharded(p, x, logits, m, e_pad)
        aux = _aux_losses(logits, torch.softmax(logits, dim=-1), share, m)
    else:
        out, r = _moe_local(x, logits, w["gate"], w["up"], w["down"], m,
                            e_pad, 0, policy)
        aux = r.aux
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
