"""Synthetic datasets (deterministic, offline-friendly).

The port's own numpy copies of ``repro.data.synthetic.synthetic_cifar``,
``synthetic_lm`` and ``synthetic_frontend_embeds``; they must give
identical arrays.

* ``synthetic_cifar`` — class-conditional images: each class has a smooth
  random prototype; samples are prototype + structured noise.
* ``synthetic_lm`` — first-order Markov token streams over ``vocab`` ids.
  Its transition table is ``(vocab, vocab)`` f32, so a full 256,000-id
  vocabulary would need 262 GB: callers training a full-width model draw
  the chain over a prefix of the ids (valid rows of the embedding).
* ``synthetic_frontend_embeds`` — stand-ins for the stubbed modality
  frontends (VLM patch embeddings, audio conditioning).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def synthetic_cifar(n: int, n_classes: int, seed: int = 0,
                    image_size: int = 32) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    # smooth prototypes: low-frequency random fields per class
    base = rng.normal(size=(n_classes, 8, 8, 3)).astype(np.float32)
    protos = np.stack([
        np.kron(base[c], np.ones((image_size // 8, image_size // 8, 1)))
        for c in range(n_classes)])
    labels = rng.integers(0, n_classes, size=n).astype(np.int32)
    noise = rng.normal(scale=0.6, size=(n, image_size, image_size, 3))
    images = protos[labels] + noise.astype(np.float32)
    return {"images": images.astype(np.float32), "labels": labels}


def synthetic_lm(n_seqs: int, seq_len: int, vocab: int,
                 seed: int = 0, n_codebooks: int = 1,
                 chain_seed: int = 1234) -> Dict[str, np.ndarray]:
    """``seed`` controls the sampled streams; ``chain_seed`` controls the
    transition structure — train/test splits must share the latter."""
    rng = np.random.default_rng(chain_seed)
    # peaked Markov chain: one dominant successor (p~0.75) + a runner-up,
    # so argmax accuracy is learnable (optimum ~0.75)
    probs = np.full((vocab, vocab), 0.1 / vocab, np.float32)
    succ = rng.permutation(vocab)
    succ2 = rng.permutation(vocab)
    for v in range(vocab):
        probs[v, succ[v]] += 0.75
        probs[v, succ2[v]] += 0.15
    probs /= probs.sum(1, keepdims=True)
    cdf = np.cumsum(probs, axis=1)

    def sample_stream(k):
        r = np.random.default_rng(seed * 7919 + k)
        out = np.empty(seq_len + 1, np.int32)
        out[0] = r.integers(vocab)
        u = r.random(seq_len)
        for t in range(seq_len):
            out[t + 1] = np.searchsorted(cdf[out[t]], u[t])
        return out

    tokens = np.stack([sample_stream(i) for i in range(n_seqs)])
    if n_codebooks > 1:
        shifted = [np.roll(tokens, c, axis=1) for c in range(n_codebooks)]
        tokens = np.stack(shifted, axis=-1)
    # labels for dirichlet splitting: dominant token bucket
    labels = (tokens.reshape(n_seqs, -1)[:, 0] % 10).astype(np.int32)
    return {"tokens": tokens, "labels": labels}


def synthetic_frontend_embeds(n: int, n_tokens: int, d_in: int,
                              seed: int = 0) -> np.ndarray:
    """(n, n_tokens, d_in) f32 draws of N(0, 0.5^2)."""
    rng = np.random.default_rng(seed)
    return rng.normal(scale=0.5, size=(n, n_tokens, d_in)).astype(np.float32)
