"""Dense GLU MLP and Mixture-of-Experts layers: the port of
``repro.models.mlp``.

MoE uses capacity-based top-k routing with a routing group per batch row
(a sequence in training and prefill; decode routes the whole batch as one
group): each group's tokens go into an ``(E, C, D)`` buffer by a gather
from ``x`` with a zero row appended (the garbage index ``S`` reads it), the
experts run as one batched product over ``E``, and each token adds its
experts' gated outputs back.  A (token, choice) pair past its expert's
capacity ``C`` is dropped, as in Switch/GShard.  The dense MLP takes the
reference's ``policy`` and constrains its hidden; MoE takes none, since
``launch/sharding.MeshPolicy`` refuses MoE configs over a live model axis
(``ROADMAP.md`` §1 item 11) and its constrains are the identity
elsewhere.

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

    # aux losses (Switch-style); ce counts each token's first choice
    me = torch.mean(probs, dim=(0, 1))                        # (E,)
    counts = torch.zeros((b, e), device=dev).scatter_add_(
        1, topk_idx[..., 0], torch.ones((b, s), device=dev))
    ce = torch.mean(counts / s, dim=0)
    load_balance = e * torch.sum(me * ce)
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    aux = {"load_balance": load_balance * moe.load_balance_loss,
           "router_z": z_loss * moe.router_z_loss}
    return Routing(slot_idx, slot_gate, topk_idx, token_slot, aux)


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


def apply_moe(p: dict, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, D) -> (out in ``x.dtype``, aux losses); each row of the
    batch is a routing group."""
    m = cfg.moe
    b, s, d = x.shape
    capacity = _capacity(m, s)
    r = _route(torch.matmul(x.float(), p["router"]), m, capacity,
               padded_experts(m))

    # dispatch: gather tokens into (B, E, C, D); garbage index S reads zeros
    xp = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)
    dispatched = xp[torch.arange(b, device=x.device)[:, None, None],
                    r.slot_idx]

    w = p["experts"]
    g = _expert_matmul(dispatched, w["gate"].to(x.dtype))
    u = _expert_matmul(dispatched, w["up"].to(x.dtype))
    y = _expert_matmul(gelu(g) * u, w["down"].to(x.dtype))

    # combine, weighted by the gate in y's dtype
    y = y * r.slot_gate[..., None].to(y.dtype)
    out = _combine(y, r.token_slot)
    for shared in p.get("shared", []):
        out = out + apply_mlp(shared, x)
    return out, r.aux
