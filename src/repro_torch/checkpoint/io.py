"""Checkpointing: a tree of tensors as one .npz and a JSON sidecar; the port
of `repro/checkpoint/io.py`, in its layout, so that each package reads the
other's checkpoints.

A tree is any nesting of dicts, lists and tuples with tensors (or arrays)
as leaves; None is an empty subtree, as in JAX. A leaf is stored under its
path: the dict keys and list or tuple indices from the root, joined by "/"
(dict keys in sorted order, as JAX flattens them), so a checkpoint
survives a reordering of the code's trees. The sidecar holds `step`, the
sorted `keys`, and each key's `shapes` and `dtypes`. Image-model parameters
cross between the packages through `convert` (the reference's convolutions
are HWIO, the port's OIHW).
"""
from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict

import numpy as np
import torch


def _walk(tree, fn: Callable, path: str = ""):
    """`tree` with every leaf replaced by fn(path, leaf), dicts visited in
    sorted key order."""
    if tree is None:
        return None
    join = lambda k: f"{path}/{k}" if path else str(k)
    if isinstance(tree, dict):
        return {k: _walk(tree[k], fn, join(k)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [_walk(v, fn, join(i)) for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(path, tree)


def _paths(tree) -> Dict[str, Any]:
    """{path: leaf}, with the reference's `_paths` keys."""
    out = {}
    _walk(tree, lambda k, leaf: out.__setitem__(k, leaf))
    return out


def _base(path: str) -> str:
    """`path` without a trailing .npz; a `.npz` inside it (a run directory
    named `sweep.npz_v2/`) is part of the path, not the extension."""
    return path[:-len(".npz")] if path.endswith(".npz") else path


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree: Any, step: int = 0):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {k: _numpy(v) for k, v in _paths(tree).items()}
    np.savez(_base(path) + ".npz", **arrays)
    meta = {"step": step, "keys": sorted(arrays),
            "shapes": {k: list(a.shape) for k, a in arrays.items()},
            "dtypes": {k: str(a.dtype) for k, a in arrays.items()}}
    with open(_base(path) + ".json", "w") as f:
        json.dump(meta, f, indent=1)


def load_pytree(path: str, template: Any) -> Any:
    """The checkpoint at `path` in `template`'s structure, each leaf a tensor
    of its template leaf's dtype on its device (a numpy template leaf: the
    CPU). A stored shape that differs from the template's is a
    ValueError."""
    with np.load(_base(path) + ".npz") as z:
        def restore(key, leaf):
            arr = z[key]
            want = tuple(leaf.shape)
            if tuple(arr.shape) != want:
                raise ValueError(
                    f"checkpoint leaf {key!r}: stored shape {arr.shape} "
                    f"does not match template shape {want}")
            if isinstance(leaf, torch.Tensor):
                return torch.from_numpy(arr).to(device=leaf.device,
                                                dtype=leaf.dtype)
            return torch.from_numpy(arr.astype(leaf.dtype))
        return _walk(template, restore)
