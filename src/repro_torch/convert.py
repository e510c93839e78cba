"""Parameter conversion between the reference's layout and the port's.

The reference's parameters travel as numpy arrays (for example
`{k: np.asarray(v) for k, v in jax_params.items()}`, or `jax.tree.map`
of `np.asarray` over an LM pytree), so this module needs neither JAX nor
the reference package. The only layout change of the image models is the
conv weights: HWIO in the reference (`repro/models/cnn.py:26-44`), OIHW in
the port. Dense weights keep their (in, out) layout, and the LeNet flattens
its pooled activation in NHWC order (`models/cnn.py`), so `fc1` is copied as
is. A leading client axis (the vectorized engines' stacked parameters) is
kept. An LM's stacked segments are split into per-layer dicts. A relay
state of any policy converts field by field (`relay_state_to_numpy`).
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device

_CONV = {"cnn": ("conv1", "conv2"), "mlp": ()}


def _conv_axes(ndim: int, perm):
    """`perm` of a 4-d conv weight, after any leading (client) axes."""
    lead = ndim - 4
    return tuple(range(lead)) + tuple(lead + i for i in perm)


def params_from_jax(np_params: Dict[str, np.ndarray], kind: str = "cnn",
                    device=None) -> Dict[str, torch.Tensor]:
    """Reference parameters (numpy, JAX layout) -> port parameters (float32
    tensors on `device`); stacked parameters keep their client axis."""
    if kind not in _CONV:
        raise ValueError(f"kind must be one of {sorted(_CONV)}, got {kind!r}")
    dev = resolve_device(device)
    out = {}
    for k, v in np_params.items():
        a = np.array(v, np.float32)                        # own copy
        if k in _CONV[kind]:
            a = a.transpose(_conv_axes(a.ndim, (3, 2, 0, 1)))   # HWIO -> OIHW
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return out


def stacked_params_from_jax(np_params_list: Sequence[Dict[str, np.ndarray]],
                            kind: str = "cnn",
                            device=None) -> Dict[str, torch.Tensor]:
    """N clients' reference parameters -> the port's stacked parameters
    (every leaf with a leading client axis), as the vectorized engine holds
    them; `VectorizedCollabTrainer.client_params(i)` unstacks client i."""
    return params_from_jax({k: np.stack([np.asarray(p[k]) for p in np_params_list])
                            for k in np_params_list[0]}, kind, device)


def params_to_numpy(params: Dict[str, torch.Tensor],
                    kind: str = "cnn") -> Dict[str, np.ndarray]:
    """Port parameters (one client's, or stacked) -> numpy arrays in the
    reference's layout."""
    if kind not in _CONV:
        raise ValueError(f"kind must be one of {sorted(_CONV)}, got {kind!r}")
    out = {}
    for k, v in params.items():
        a = v.detach().cpu().numpy()
        if k in _CONV[kind]:
            a = a.transpose(_conv_axes(a.ndim, (2, 3, 1, 0)))   # OIHW -> HWIO
        out[k] = np.ascontiguousarray(a)
    return out


def _tensor(a, device) -> torch.Tensor:
    """numpy array -> tensor of the same dtype (bfloat16 arrays, which numpy
    knows only through an extension dtype, by their bits)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()
                                ).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def lm_params_from_jax(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """The reference's `lm.init_lm` pytree, its leaves as numpy arrays ->
    the port's LM parameters (`models/lm.py`) on `device`, same dtypes.

    `segments[i]` is a dict of leaves stacked on a leading layer axis in the
    reference; here it becomes a list of per-layer dicts. Dense weights keep
    the reference's (in, out) layout (the port multiplies `x @ w`), so no
    leaf is transposed."""
    dev = resolve_device(device)
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if k == "segments":
            segs = []
            for seg in v:
                n = len(np.asarray(seg["norm1"]["scale"]))
                segs.append([_map(seg, lambda a, i=i: _tensor(np.asarray(a)[i],
                                                               dev))
                             for i in range(n)])
            out[k] = segs
        else:
            out[k] = _map(v, lambda a: _tensor(a, dev))
    return out


def relay_state_to_numpy(state) -> Dict[str, np.ndarray]:
    """Any relay policy's state (a NamedTuple of tensors) -> {field: numpy
    array}, field by field, as the reference's state holds them."""
    return {f: getattr(state, f).detach().cpu().numpy() for f in state._fields}
