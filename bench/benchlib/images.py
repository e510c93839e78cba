"""Synthetic class images and LeNet5 weights made on the device from a
seed, in a few large calls: the fleet's traffic and weights.

The class templates are a copy of the port's
`data/synthetic.class_images` (each class a mixture of `modes`
sub-templates sharing two anchor blobs, with a third blob and a grating
that differ by mode; the same fixed template seed), so the fleet learns
the same task. The samples are drawn from the run's seed: a class and a
mode, a shift of up to 2 pixels each way, a gain in [0.8, 1.2] and
Gaussian noise, clipped to [-2, 2]; all samples at once on the device.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

TEMPLATE_SEED = 12345


def templates(num_classes: int, image: int, modes: int) -> np.ndarray:
    """(C, modes, image, image) float32, the port's generator's."""
    yy, xx = np.meshgrid(np.linspace(-1, 1, image), np.linspace(-1, 1, image),
                         indexing="ij")
    rng = np.random.default_rng(TEMPLATE_SEED)
    blob = lambda cx, cy, s: np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2)
                                    / (2 * s * s))
    out = np.zeros((num_classes, modes, image, image), np.float32)
    for c in range(num_classes):
        base = sum(blob(*rng.uniform(-0.6, 0.6, 2), rng.uniform(0.15, 0.3))
                   for _ in range(2))
        fx, fy = rng.uniform(2, 6, 2)
        for m in range(modes):
            t = base + blob(*rng.uniform(-0.7, 0.7, 2),
                            rng.uniform(0.1, 0.25)) * 1.5
            ph = rng.uniform(0, 2 * np.pi)
            t = t + 0.5 * np.sin(fx * np.pi * xx + fy * np.pi * yy + ph)
            out[c, m] = t / np.abs(t).max()
    return out


def class_images(gen: torch.Generator, n: int, cfg: Dict,
                 noise: float, modes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> x (n, image, image, 1) float32 NHWC, y (n,) int32, on gen's
    device."""
    dev = gen.device
    C, H = cfg["num_classes"], cfg["image"]
    tpl = torch.from_numpy(templates(C, H, modes)).to(dev)
    y = torch.randint(0, C, (n,), generator=gen, device=dev)
    m = torch.randint(0, modes, (n,), generator=gen, device=dev)
    shift = torch.randint(-2, 3, (n, 2), generator=gen, device=dev)
    gain = 0.8 + 0.4 * torch.rand(n, generator=gen, device=dev)
    eps = noise * torch.randn(n, H, H, generator=gen, device=dev)
    ar = torch.arange(H, device=dev)
    rows = (ar[None, :] - shift[:, :1]) % H                    # (n, H)
    cols = (ar[None, :] - shift[:, 1:]) % H
    t = tpl[y, m]                                              # (n, H, H)
    k = torch.arange(n, device=dev)[:, None, None]
    img = t[k, rows[:, :, None], cols[:, None, :]]
    x = (img * gain[:, None, None] + eps).clamp(-2, 2)
    return x[..., None].contiguous(), y.to(torch.int32)


def lenet_weights(gen: torch.Generator, n_clients: int,
                  cfg: Dict) -> Dict[str, torch.Tensor]:
    """Stacked (N, ...) float32 LeNet5 weights, one call a leaf: He-normal
    convolutions, dense layers N(0, 1/fan_in), zero biases (the port's
    `models/cnn.init_cnn` distributions)."""
    dev, N = gen.device, n_clients
    img, ci = cfg["image"], cfg["in_channels"]
    c1, c2 = cfg["conv_channels"]
    s2 = ((img - 4) // 2 - 4) // 2
    f1, d, C = cfg["fc_width"], cfg["d_feature"], cfg["num_classes"]
    rn = lambda *s: torch.randn(N, *s, generator=gen, device=dev)
    z = lambda *s: torch.zeros(N, *s, device=dev)
    return {
        "conv1": rn(c1, ci, 5, 5) * math.sqrt(2.0 / (25 * ci)), "b1": z(c1),
        "conv2": rn(c2, c1, 5, 5) * math.sqrt(2.0 / (25 * c1)), "b2": z(c2),
        "fc1": rn(c2 * s2 * s2, f1) / math.sqrt(c2 * s2 * s2), "fb1": z(f1),
        "fc2": rn(f1, d) / math.sqrt(f1), "fb2": z(d),
        "head_w": rn(d, C) / math.sqrt(d), "head_b": z(C),
    }


def fleet_inputs(seed: int, n_clients: int, cfg: Dict, device) -> Dict:
    """Everything the fleet starts from: weights, each client's samples and
    the shared test set, from one generator on `device`."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    w = lenet_weights(gen, n_clients, cfg)
    n = cfg["samples_per_client"]
    x, y = class_images(gen, n_clients * n, cfg, cfg["noise"], cfg["modes"])
    tx, ty = class_images(gen, cfg["test_samples"], cfg, cfg["noise"],
                          cfg["modes"])
    H = cfg["image"]
    return {"params": w, "x": x.reshape(n_clients, n, H, H, 1),
            "y": y.reshape(n_clients, n), "test_x": tx, "test_y": ty}
