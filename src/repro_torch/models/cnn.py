"""LeNet5-style CNN, the paper's own MNIST model (about 30K parameters,
d' = 84); the port of `repro/models/cnn.py`.

f_u = tau_u o phi_u: `features` returns the d'-dim last-hidden
representation (what CoRS shares), `classify` is the linear head tau_u.

Parameters are a plain dict of tensors. Conv weights are OIHW (PyTorch's
layout; `convert.params_from_jax` maps the reference's HWIO). Dense weights
keep the reference's (in, out) layout. Images are NHWC at the public
boundary, as in the reference, and the pooled activation is flattened in
NHWC order, so `fc1`'s rows are HWC-ordered exactly as in JAX and need no
permutation. Convolution and pooling are library calls: the reference leaves
them to XLA, outside any Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device


def _dense_init(g: torch.Generator, d_in: int, d_out: int) -> torch.Tensor:
    return torch.randn(d_in, d_out, generator=g) / math.sqrt(d_in)


def init_cnn(generator: torch.Generator, *, num_classes: int = 10,
             d_feature: int = 84, in_ch: int = 1, width: int = 1,
             image: int = 28, device=None) -> Dict[str, torch.Tensor]:
    """Random LeNet5 parameters drawn from a CPU `torch.Generator` (the same
    distributions as the reference's `init_cnn`, other numbers), then moved
    to `device`."""
    dev = resolve_device(device)
    g = generator
    c1, c2 = 6 * width, 16 * width
    s1 = (image - 4) // 2
    s2 = (s1 - 4) // 2
    flat = c2 * s2 * s2
    conv = lambda ci, co: (torch.randn(co, ci, 5, 5, generator=g)
                           * math.sqrt(2.0 / (25 * ci)))
    params = {
        "conv1": conv(in_ch, c1), "b1": torch.zeros(c1),
        "conv2": conv(c1, c2), "b2": torch.zeros(c2),
        "fc1": _dense_init(g, flat, 120 * width),
        "fb1": torch.zeros(120 * width),
        "fc2": _dense_init(g, 120 * width, d_feature),
        "fb2": torch.zeros(d_feature),
        # tau_u, the linear classifier (W_u, b_u) of the paper
        "head_w": _dense_init(g, d_feature, num_classes),
        "head_b": torch.zeros(num_classes),
    }
    return {k: v.to(dev) for k, v in params.items()}


def features(params, x):
    """phi_u: x (B, H, W, C) -> s (B, d'). tanh feature layer, as LeNet5's
    F6 (see the reference's docstring for why it is bounded)."""
    h = x.permute(0, 3, 1, 2)
    h = F.max_pool2d(F.relu(F.conv2d(h, params["conv1"], params["b1"])), 2)
    h = F.max_pool2d(F.relu(F.conv2d(h, params["conv2"], params["b2"])), 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)   # NHWC flatten order
    h = F.relu(h @ params["fc1"] + params["fb1"])
    return torch.tanh(h @ params["fc2"] + params["fb2"])


def classify(params, s):
    """tau_u: s (B, d') -> logits (B, C)."""
    return s @ params["head_w"] + params["head_b"]


def apply(params, x):
    s = features(params, x)
    return s, classify(params, s)


def num_params(params) -> int:
    return sum(int(p.numel()) for p in params.values())
