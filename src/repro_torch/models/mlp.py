"""Small MLP client, the cheap-compute counterpart of models/cnn.py; the
port of `repro/models/mlp.py`. Same f_u = tau_u o phi_u contract and the same
(in, out) dense layout as the reference."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.cnn import _dense_init, classify, num_params  # noqa: F401


def init_mlp(generator: torch.Generator, *, num_classes: int = 10,
             d_feature: int = 84, d_in: int = 784, hidden: int = 64,
             device=None) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    g = generator
    params = {
        "w1": _dense_init(g, d_in, hidden), "b1": torch.zeros(hidden),
        "w2": _dense_init(g, hidden, d_feature), "b2": torch.zeros(d_feature),
        # tau_u, the linear classifier (W_u, b_u) of the paper
        "head_w": _dense_init(g, d_feature, num_classes),
        "head_b": torch.zeros(num_classes),
    }
    return {k: v.to(dev) for k, v in params.items()}


def features(params, x):
    """phi_u: x (B, ...) flattened -> s (B, d')."""
    h = x.reshape(x.shape[0], -1)
    h = F.relu(h @ params["w1"] + params["b1"])
    return torch.tanh(h @ params["w2"] + params["b2"])


def apply(params, x):
    s = features(params, x)
    return s, classify(params, s)
