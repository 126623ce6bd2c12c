"""Synthetic datasets (deterministic, offline-friendly).

The port's own numpy copy of ``repro.data.synthetic.synthetic_cifar``; it
must give identical arrays.  ``synthetic_lm`` comes with the LM slice.

* ``synthetic_cifar`` — class-conditional images: each class has a smooth
  random prototype; samples are prototype + structured noise.
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
