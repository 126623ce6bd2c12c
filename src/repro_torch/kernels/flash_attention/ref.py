"""Plain PyTorch version of the sliding-window flash attention kernel.

The port of ``repro.kernels.flash_attention.ref``: a naive O(S^2) masked
softmax, sharing no code with the kernel or with the model's chunked path.
It is the CPU path of :func:`repro_torch.kernels.flash_attention.ops.
flash_attention` and the version K5 is held against on the card.
"""

from __future__ import annotations

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, window: int = 0, softcap: float = 0.0,
                        q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, Dh); k, v: (B, Sk, Kh, Dh); causal (+ window) -> like
    q.

    Query row ``i`` sits at position ``q_offset + i`` and keeps key ``j``
    where ``j <= q_offset + i`` and, when windowed, ``q_offset + i - j <
    window`` (``q_offset + Sq <= Sk``; 0 with ``Sq = Sk`` is the whole
    sequence).  Query head ``h`` reads kv head ``h // (H // Kh)``.  q, k and
    v are widened to f32, the scale is ``Dh ** -0.5``, probabilities stay
    f32, and the output is rounded to ``q.dtype`` once."""
    b, s, h, dh = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, s, kh, h // kh, dh).float()
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * dh ** -0.5
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    qpos = q_offset + torch.arange(s, device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = qpos[:, None] >= kpos[None, :]
    if window:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(b, s, h, dh).to(q.dtype)
