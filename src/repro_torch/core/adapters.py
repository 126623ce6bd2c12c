"""Model adapters: bind an architecture to the FedHeN machinery.

The port of ``repro.core.adapters``.  An adapter exposes the paper's
three client objectives over a *complex* parameter tree:

* ``loss_complex`` — f_j(w_c)
* ``loss_simple``  — f_i([w_c]_M): touches only M, so PyTorch returns no
  gradient (``None``) for a leaf wholly outside M, which the optimizer
  reads as zero (a period-stacked leaf gets a full-shape gradient, zero
  past the exit)
* ``loss_side``    — f_j(w_c) + f_j([w_c]_M), in ONE forward pass

plus ``subnet_mask`` (index set M) and evaluation metrics for both heads.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import masking
from repro_torch.models import common, resnet
from repro_torch.models.common import NO_POLICY, Policy
from repro_torch.models import transformer as tfm
from repro_torch.tree import Tree, tree_map

Batch = Dict[str, torch.Tensor]
# logits elements LMAdapter.evaluate builds at once (its rows are grouped)
EVAL_LOGITS = 1 << 28


def _resnet_ce(logits, labels):
    """The ResNet's mean CE: PyTorch's fused ``F.cross_entropy`` in f32,
    within f32 rounding of the reference's formula
    (``common.softmax_cross_entropy``, which the LM uses).  The ResNet
    keeps the fused form because four of its lossy-wire and SCAFFOLD
    parity tests sit at the last ulp and fail under the reference's
    formula (a compressed round's share 0.0033 against 0.001, a loss
    1.9e-5 off at atol 1e-5, a cv row 1.2e-6 off at atol 1e-6, an int8
    gradient), and under it one client of ``chip_smoke.py``'s narrow
    compressed round trains on the card to deltas 2.1e-3 away from the
    CPU's (ROADMAP section 3 item 3)."""
    return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long())


def _acc(logits, labels):
    return (logits.argmax(-1) == labels.long()).float().mean()


class ResNetAdapter:
    """PreActResNet18-GN complex / 2-stage+mixpool simple (paper §3).
    ``channels`` are the stage widths (the paper's by default)."""

    def __init__(self, n_classes: int = 10,
                 channels: Sequence[int] = resnet.STAGE_CHANNELS):
        self.n_classes = n_classes
        self.channels = tuple(channels)

    def init(self, generator: torch.Generator, device) -> Tree:
        """Params drawn on the CPU from ``generator``, then moved to
        ``device`` — the same seed gives the same weights on every
        device."""
        params = resnet.init_params(generator, self.n_classes, self.channels)
        return tree_map(lambda x: x.to(device), params)

    def subnet_mask(self, params: Tree) -> Tree:
        return masking.resnet_subnet_mask(params)

    def loss_complex(self, params: Tree, batch: Batch) -> torch.Tensor:
        _, final = resnet.forward(params, batch["images"])
        return _resnet_ce(final, batch["labels"])

    def loss_simple(self, params: Tree, batch: Batch) -> torch.Tensor:
        logits = resnet.forward_simple(params, batch["images"])
        return _resnet_ce(logits, batch["labels"])

    def loss_side(self, params: Tree, batch: Batch) -> torch.Tensor:
        exit_logits, final = resnet.forward(params, batch["images"])
        return (_resnet_ce(final, batch["labels"])
                + _resnet_ce(exit_logits, batch["labels"]))

    @torch.no_grad()
    def evaluate(self, params: Tree, batch: Batch) -> Dict[str, torch.Tensor]:
        exit_logits, final = resnet.forward(params, batch["images"])
        return {"acc_complex": _acc(final, batch["labels"]),
                "acc_simple": _acc(exit_logits, batch["labels"])}


# ---------------------------------------------------------------------------
# Decoder LM zoo
# ---------------------------------------------------------------------------

class LMAdapter:
    """A ``ModelConfig`` of the zoo.  Batch: ``tokens`` (B, S+1), or (B,
    S+1, n_codebooks) for a multi-codebook config; the model reads
    ``tokens[:, :-1]`` and predicts ``tokens[:, 1:]``.  An optional
    ``extra_embeds`` (B, N, d_in) feeds a config's frontend: its N
    positions are prepended, and the losses and metrics count the token
    positions only.  With codebooks a loss averages the codebooks' CE, and
    the metrics read codebook 0, as the reference's do.

    ``remat`` checkpoints each period of the stack (the reference's
    ``jax.checkpoint`` of its scan body).  ``policy`` is the reference's
    sharding policy, handed to every forward and head; under a ``dp2d``
    policy the CE is computed in one piece, as the reference's is."""

    def __init__(self, cfg: ModelConfig, policy: Policy = NO_POLICY,
                 remat: bool = False):
        self.cfg = cfg
        self.policy = policy
        self.remat = remat

    def init(self, generator: torch.Generator, device) -> Tree:
        """Params drawn from ``generator`` on its own device, then moved
        to ``device``: a CPU generator gives the same weights on every
        device, a CUDA one draws a full-width model on the card."""
        params = tfm.init_params(generator, self.cfg)
        return tree_map(lambda x: x.to(device), params)

    def subnet_mask(self, params: Tree) -> Tree:
        return masking.transformer_subnet_mask(params, self.cfg)

    # -- loss plumbing -----------------------------------------------------

    def _inputs(self, batch: Batch):
        tokens = batch["tokens"]
        return tokens[:, :-1], tokens[:, 1:], batch.get("extra_embeds")

    def _head_loss(self, params: Tree, h: torch.Tensor,
                   labels: torch.Tensor, head: str, chunk: int = 256,
                   extra: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Mean CE between the ``head`` logits of ``h`` and ``labels``,
        over the token positions (the first ``extra.shape[1]`` positions
        of ``h`` are the frontend's); with codebooks, each chunk's sum is
        the codebooks' CE sums added in order and divided by their count
        (over a live model axis the logits may be sharded over their
        codebooks, and the sum is reduced before the division:
        ``common.codebook_cross_entropy_sum``).

        A sequence longer than ``2 * chunk`` that ``chunk`` divides is
        summed chunk by chunk, in order, into an f32 scalar, each chunk
        under ``torch.utils.checkpoint`` (its logits are recomputed in the
        backward pass), so the (B, S, V) logits never exist at once: the
        reference's remat'd scan.  Otherwise one piece."""
        if extra is not None:
            h = h[:, extra.shape[1]:]
        b, s = h.shape[0], h.shape[1]
        nc = self.cfg.n_codebooks
        if getattr(self.policy, "dp2d", False):
            chunk = s     # the reference's one-piece CE under dp2d

        def nll_sum(h_c, lab_c):
            logits = tfm.logits_from_hidden(params, self.cfg, h_c, head,
                                            self.policy)
            if nc == 1:
                return common.softmax_cross_entropy_sum(logits, lab_c)
            return common.codebook_cross_entropy_sum(logits, lab_c) / nc

        n_tok = b * s
        if s <= 2 * chunk or s % chunk:
            return nll_sum(h, labels) / n_tok
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for c in range(s // chunk):
            sl = slice(c * chunk, (c + 1) * chunk)
            total = total + checkpoint(nll_sum, h[:, sl], labels[:, sl],
                                       use_reentrant=False)
        return total / n_tok

    def loss_complex(self, params: Tree, batch: Batch) -> torch.Tensor:
        inputs, labels, extra = self._inputs(batch)
        _, final_h, aux = tfm.forward(params, self.cfg, inputs,
                                      extra_embeds=extra, policy=self.policy,
                                      remat=self.remat)
        loss = self._head_loss(params, final_h, labels, "final", extra=extra)
        return loss + aux["load_balance"] + aux["router_z"]

    def loss_simple(self, params: Tree, batch: Batch) -> torch.Tensor:
        inputs, labels, extra = self._inputs(batch)
        exit_h = tfm.forward_simple(params, self.cfg, inputs,
                                    extra_embeds=extra, policy=self.policy,
                                    remat=self.remat)
        return self._head_loss(params, exit_h, labels, "exit", extra=extra)

    def loss_side(self, params: Tree, batch: Batch) -> torch.Tensor:
        """f(w_c) + f([w_c]_M) — one forward pass, two heads."""
        inputs, labels, extra = self._inputs(batch)
        exit_h, final_h, aux = tfm.forward(params, self.cfg, inputs,
                                           extra_embeds=extra,
                                           policy=self.policy,
                                           remat=self.remat)
        loss = (self._head_loss(params, final_h, labels, "final",
                                extra=extra)
                + self._head_loss(params, exit_h, labels, "exit",
                                  extra=extra))
        return loss + aux["load_balance"] + aux["router_z"]

    @torch.no_grad()
    def evaluate(self, params: Tree, batch: Batch) -> Dict[str, torch.Tensor]:
        """Accuracy and mean CE of both heads, through the training
        forward (not prefill), as the reference evaluates.  The batch's
        rows go through in groups of at most :data:`EVAL_LOGITS` logits
        (a test batch of 64 x 512 tokens would need 33 GB of f32 logits
        at Gemma-2's vocabulary); the counts and NLL sums add up across
        groups, so the means are the whole batch's.  The metrics count the
        token positions, and with codebooks codebook 0 only."""
        inputs, labels, extra = self._inputs(batch)
        b, s = labels.shape[0], labels.shape[1]
        n_extra = 0 if extra is None else extra.shape[1]
        nc = self.cfg.n_codebooks
        rows = max(1, EVAL_LOGITS // (s * nc * self.cfg.vocab_size))
        if nc > 1:
            labels = labels[..., 0]
        hits = {"complex": 0.0, "simple": 0.0}
        nll = {"complex": 0.0, "simple": 0.0}
        for r in range(0, b, rows):
            lab = labels[r:r + rows]
            exit_h, final_h, _ = tfm.forward(
                params, self.cfg, inputs[r:r + rows],
                extra_embeds=None if extra is None else extra[r:r + rows],
                policy=self.policy)
            for name, head, h in (("complex", "final", final_h),
                                  ("simple", "exit", exit_h)):
                logits = tfm.logits_from_hidden(params, self.cfg,
                                                h[:, n_extra:], head,
                                                self.policy)
                if nc > 1:
                    logits = logits[..., 0, :]
                hits[name] = hits[name] + (logits.argmax(-1) == lab.long()
                                           ).sum().float()
                nll[name] = nll[name] + common.softmax_cross_entropy_sum(
                    logits, lab)
        out = {}
        for name in ("complex", "simple"):
            out[f"acc_{name}"] = hits[name] / (b * s)
            out[f"loss_{name}"] = nll[name] / (b * s)
        return out
