"""Federated dataset splits (paper §3 'FL dataset').

* IID: random equal partition over clients.
* Non-IID: Dirichlet prior over label proportions per client
  (Yurochkin et al. 2019), concentration alpha.

The port's own copy of ``repro.data.federated`` (numpy only); it must give
identical shards.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

Batch = Dict[str, np.ndarray]


def iid_split(data: Batch, n_clients: int, seed: int = 0) -> List[Batch]:
    n = len(next(iter(data.values())))
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    per = n // n_clients
    return [
        {k: v[perm[i * per:(i + 1) * per]] for k, v in data.items()}
        for i in range(n_clients)]


def dirichlet_split(data: Batch, n_clients: int, alpha: float,
                    seed: int = 0, label_key: str = "labels") -> List[Batch]:
    """Label-Dirichlet non-IID split; every client gets an equal-size shard
    (sampling without replacement within classes, topping up IID if a class
    runs dry) so client datasets stay shape-static for vmapped training."""
    labels = np.asarray(data[label_key])
    n = len(labels)
    per = n // n_clients
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    pools = {c: list(rng.permutation(np.where(labels == c)[0]))
             for c in classes}

    shards = []
    for i in range(n_clients):
        props = rng.dirichlet(np.full(len(classes), alpha))
        # largest-remainder rounding: hand the floor-rounding shortfall to
        # the classes with the largest fractional parts (dumping it all on
        # the last class would bias its realized marginal high)
        ideal = props * per
        counts = np.floor(ideal).astype(int)
        short = per - counts.sum()
        if short:
            order = np.argsort(-(ideal - counts))
            counts[order[:short]] += 1
        take: List[int] = []
        for c, k in zip(classes, counts):
            pool = pools[c]
            got = pool[:k]
            pools[c] = pool[k:]
            take.extend(got)
        # top up from any remaining indices if classes ran dry — in a
        # fresh random class order each pass, so the top-up surplus does
        # not systematically favor the low class ids
        while len(take) < per:
            for c in rng.permutation(classes):
                if pools[c]:
                    take.append(pools[c].pop())
                    if len(take) == per:
                        break
        idx = np.asarray(take[:per])
        shards.append({k: v[idx] for k, v in data.items()})
    return shards


def label_distribution(shards: List[Batch], n_classes: int,
                       label_key: str = "labels") -> np.ndarray:
    out = np.zeros((len(shards), n_classes))
    for i, s in enumerate(shards):
        lab, cnt = np.unique(s[label_key], return_counts=True)
        out[i, lab] = cnt
    # an empty shard has no distribution: keep its row zero, not NaN
    totals = out.sum(1, keepdims=True)
    return out / np.maximum(totals, 1.0)
