"""Parameter conversion between the reference's layout and the port's.

The reference's parameters travel as a dict of numpy arrays (for example
`{k: np.asarray(v) for k, v in jax_params.items()}`), so this module needs
neither JAX nor the reference package. The only layout change is the conv
weights: HWIO in the reference (`repro/models/cnn.py:26-44`), OIHW in the
port. Dense weights keep their (in, out) layout, and the LeNet flattens its
pooled activation in NHWC order (`models/cnn.py`), so `fc1` is copied as is.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.device import resolve_device

_CONV = {"cnn": ("conv1", "conv2"), "mlp": ()}


def params_from_jax(np_params: Dict[str, np.ndarray], kind: str = "cnn",
                    device=None) -> Dict[str, torch.Tensor]:
    """Reference parameters (numpy, JAX layout) -> port parameters (float32
    tensors on `device`)."""
    if kind not in _CONV:
        raise ValueError(f"kind must be one of {sorted(_CONV)}, got {kind!r}")
    dev = resolve_device(device)
    out = {}
    for k, v in np_params.items():
        a = np.array(v, np.float32)                        # own copy
        if k in _CONV[kind]:
            a = a.transpose(3, 2, 0, 1)                      # HWIO -> OIHW
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return out


def params_to_numpy(params: Dict[str, torch.Tensor],
                    kind: str = "cnn") -> Dict[str, np.ndarray]:
    """Port parameters -> numpy arrays in the reference's layout."""
    if kind not in _CONV:
        raise ValueError(f"kind must be one of {sorted(_CONV)}, got {kind!r}")
    out = {}
    for k, v in params.items():
        a = v.detach().cpu().numpy()
        if k in _CONV[kind]:
            a = a.transpose(2, 3, 1, 0)                      # OIHW -> HWIO
        out[k] = np.ascontiguousarray(a)
    return out
