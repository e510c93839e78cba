"""Checkpointing: a tree of tensors as one .npz and a JSON sidecar; the port
of `repro/checkpoint/io.py`, in its layout, so that each package reads the
other's checkpoints.

A tree is any nesting of dicts, lists, tuples and NamedTuples with tensors
(or arrays) as leaves; None is an empty subtree, as in JAX. A leaf is
stored under its path: the dict keys, list or tuple indices and NamedTuple
fields (as `.{name}`, JAX's `GetAttrKey`) from the root, joined by "/"
(dict keys in sorted order, as JAX flattens them), so a checkpoint
survives a reordering of the code's trees, and a NamedTuple (an
`AdamState`, a relay state, a `TrainState`) loads back as its own type.
The sidecar holds `step`, the sorted `keys`, and each key's `shapes` and
`dtypes`. A bfloat16 leaf is stored as the reference stores it: its raw
2-byte words as `<V2` data, "bfloat16" in `dtypes`; a load reads it back
by that dtype. Image-model parameters cross between the packages through
`convert` (the reference's convolutions are HWIO, the port's OIHW).
"""
from __future__ import annotations

import json
import os
import zipfile
from typing import Any, Callable, Dict, Optional

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
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_walk(getattr(tree, f), fn, join("." + f))
                            for f in tree._fields])
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


_BF16 = "bfloat16"


def _numpy(leaf):
    """-> (numpy array, dtype name); a bfloat16 tensor as its 2-byte words
    (numpy has no bfloat16 of its own)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view("V2"), _BF16
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def _write_npy(fid, a: np.ndarray, dtype: str) -> None:
    """One .npy member as `np.savez` writes it; a bfloat16 leaf with the
    reference's `<V2` header (a numpy void dtype would say `|V2`)."""
    if dtype != _BF16:
        np.lib.format.write_array(fid, a)
        return
    np.lib.format.write_array_header_1_0(
        fid, {"descr": "<V2", "fortran_order": False, "shape": a.shape})
    fid.write(np.ascontiguousarray(a).tobytes())


def save_pytree(path: str, tree: Any, step: int = 0):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    leaves = {k: _numpy(v) for k, v in _paths(tree).items()}
    # the members of np.savez(path, **arrays), in its order and format
    with zipfile.ZipFile(_base(path) + ".npz", "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for k, (a, dt) in leaves.items():
            with zf.open(k + ".npy", "w", force_zip64=True) as fid:
                _write_npy(fid, a, dt)
    meta = {"step": step, "keys": sorted(leaves),
            "shapes": {k: list(a.shape) for k, (a, _) in leaves.items()},
            "dtypes": {k: dt for k, (_, dt) in leaves.items()}}
    with open(_base(path) + ".json", "w") as f:
        json.dump(meta, f, indent=1)


def _stored_dtypes(path: str) -> Dict[str, str]:
    try:
        with open(_base(path) + ".json") as f:
            return json.load(f).get("dtypes", {})
    except FileNotFoundError:
        return {}


def _tensor(arr: np.ndarray, dtype: Optional[str]) -> torch.Tensor:
    if dtype == _BF16:
        words = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(words.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def load_pytree(path: str, template: Any) -> Any:
    """The checkpoint at `path` in `template`'s structure, each leaf a tensor
    of its template leaf's dtype on its device (a numpy template leaf: the
    CPU). A bfloat16 leaf is read by the sidecar's dtype. A stored shape
    that differs from the template's is a ValueError."""
    dtypes = _stored_dtypes(path)
    with np.load(_base(path) + ".npz") as z:
        def restore(key, leaf):
            arr = z[key]
            want = tuple(leaf.shape)
            if tuple(arr.shape) != want:
                raise ValueError(
                    f"checkpoint leaf {key!r}: stored shape {arr.shape} "
                    f"does not match template shape {want}")
            dt = dtypes.get(key)
            if isinstance(leaf, torch.Tensor):
                return _tensor(arr, dt).to(device=leaf.device,
                                           dtype=leaf.dtype)
            if dt == _BF16:
                return _tensor(arr, dt)
            return torch.from_numpy(arr.astype(leaf.dtype))
        return _walk(template, restore)
