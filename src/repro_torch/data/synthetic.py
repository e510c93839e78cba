"""Synthetic data: numpy copies of the reference's
`repro/data/synthetic.py:class_images`, `token_stream` and `lm_batches`,
bit-equal for the same arguments."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def class_images(n: int, *, num_classes: int = 10, image: int = 28,
                 channels: int = 1, noise: float = 0.5, modes: int = 4,
                 seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """-> x (n, image, image, channels) float32 (NHWC), y (n,) int32.

    Each class is a mixture of `modes` sub-templates that share two anchor
    blobs (the class identity) and differ in a third blob and a grating
    phase, so a small local dataset under-covers the modes."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, size=n).astype(np.int32)
    m_id = rng.integers(0, modes, size=n)
    xs = np.zeros((n, image, image, channels), np.float32)
    yy, xx = np.meshgrid(np.linspace(-1, 1, image), np.linspace(-1, 1, image),
                         indexing="ij")
    tpl_rng = np.random.default_rng(12345)
    blob = lambda cx, cy, s: np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2)
                                    / (2 * s * s))
    templates = []                       # [class][mode] -> (image, image)
    for c in range(num_classes):
        base = sum(blob(*tpl_rng.uniform(-0.6, 0.6, 2),
                        tpl_rng.uniform(0.15, 0.3)) for _ in range(2))
        fx, fy = tpl_rng.uniform(2, 6, 2)
        per_class = []
        for m in range(modes):
            t = base + blob(*tpl_rng.uniform(-0.7, 0.7, 2),
                            tpl_rng.uniform(0.1, 0.25)) * 1.5
            ph = tpl_rng.uniform(0, 2 * np.pi)
            t = t + 0.5 * np.sin(fx * np.pi * xx + fy * np.pi * yy + ph)
            per_class.append(t / np.abs(t).max())
        templates.append(per_class)
    for i in range(n):
        t = templates[y[i]][m_id[i]]
        shift = rng.integers(-2, 3, size=2)
        img = np.roll(np.roll(t, shift[0], axis=0), shift[1], axis=1)
        img = img * rng.uniform(0.8, 1.2) + rng.normal(0, noise, (image, image))
        xs[i, :, :, 0] = img
    return np.clip(xs, -2, 2).astype(np.float32), y


def token_stream(n_tokens: int, *, vocab: int = 512, order: int = 2,
                 seed: int = 0) -> np.ndarray:
    """Markov token stream: learnable structure (per-context peaked
    next-token distributions)."""
    rng = np.random.default_rng(seed)
    # sparse transition structure: each context maps to 4 likely tokens
    n_ctx = 4096
    ctx_next = rng.integers(0, vocab, size=(n_ctx, 4))
    toks = np.zeros(n_tokens, np.int32)
    toks[:order] = rng.integers(0, vocab, order)
    h = 0
    for i in range(order, n_tokens):
        h = (h * 31 + int(toks[i - 1])) % n_ctx
        if rng.random() < 0.8:
            toks[i] = ctx_next[h, rng.integers(4)]
        else:
            toks[i] = rng.integers(vocab)
    return toks


def lm_batches(tokens: np.ndarray, batch: int, seq: int, steps: int,
               seed: int = 0):
    """Yield dicts(tokens (B,S), labels (B,S)) sliced from the stream."""
    rng = np.random.default_rng(seed)
    n = len(tokens) - seq - 1
    for _ in range(steps):
        idx = rng.integers(0, n, size=batch)
        x = np.stack([tokens[i:i + seq] for i in idx])
        y = np.stack([tokens[i + 1:i + seq + 1] for i in idx])
        yield {"tokens": x, "labels": y}
