"""Federated data partitioning: a numpy copy of the reference's
`repro/data/partition.py:uniform_split` (the paper's setup: 'split uniformly
at random across N users')."""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def uniform_split(x: np.ndarray, y: np.ndarray, n_clients: int,
                  seed: int = 0) -> List[Tuple[np.ndarray, np.ndarray]]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(x))
    parts = np.array_split(idx, n_clients)
    return [(x[p], y[p]) for p in parts]
