"""Federated data partitioning: numpy copies of the reference's
`repro/data/partition.py`, bit-equal for a seed: uniform (the paper's
setup: 'split uniformly at random across N users') and Dirichlet
label-skew (the standard non-IID stressor)."""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def uniform_split(x: np.ndarray, y: np.ndarray, n_clients: int,
                  seed: int = 0) -> List[Tuple[np.ndarray, np.ndarray]]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(x))
    parts = np.array_split(idx, n_clients)
    return [(x[p], y[p]) for p in parts]


def dirichlet_split(x: np.ndarray, y: np.ndarray, n_clients: int,
                    alpha: float = 0.5, seed: int = 0,
                    num_classes: int | None = None):
    rng = np.random.default_rng(seed)
    C = num_classes or int(y.max()) + 1
    client_idx: List[List[int]] = [[] for _ in range(n_clients)]
    for c in range(C):
        ids = np.where(y == c)[0]
        rng.shuffle(ids)
        props = rng.dirichlet([alpha] * n_clients)
        cuts = (np.cumsum(props) * len(ids)).astype(int)[:-1]
        for i, part in enumerate(np.split(ids, cuts)):
            client_idx[i].extend(part.tolist())
    out = []
    for ids in client_idx:
        ids = np.array(sorted(ids), int)
        out.append((x[ids], y[ids]))
    return out
