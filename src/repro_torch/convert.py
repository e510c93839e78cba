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
state of any policy converts field by field (`relay_state_to_numpy`). An
encoder-decoder's `enc_layers` and `dec_layers` are split into per-layer
lists the same way (`encdec_params_from_jax`, `encdec_params_to_numpy`).
An LM `TrainState` of either kind converts both ways
(`train_state_from_jax`, `train_state_to_numpy`): stacked clients,
layer-stacked segments or layers to per-layer lists and back, the stacked
`AdamState`, the `ProtoState` and the step.
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
    """numpy array (or tensor) -> tensor of the same dtype (bfloat16 arrays,
    which numpy knows only through an extension dtype, by their bits)."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()
                                ).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _take(a, i: int, axis: int):
    return a[i] if axis == 0 else a[:, i]


def lm_params_from_jax(tree: Dict[str, Any], device=None,
                       clients: bool = False) -> Dict[str, Any]:
    """The reference's `lm.init_lm` pytree (any decoder-only arch), its
    leaves as numpy arrays (or CPU tensors) -> the port's LM parameters
    (`models/lm.py`) on `device`, same dtypes (the float32 MoE router and
    mamba `A_log`, `dt_bias` and `D` among bf16 weights). With `clients`,
    every leaf leads with a client axis (a `TrainState`'s), which is kept.

    `segments[i]` is a dict of leaves stacked on a layer axis in the
    reference (after the client axis; MoE's stacked `_e` expert weights
    keep their expert axis after it); here it becomes a list of per-layer
    dicts. The unstacked `shared` block (zamba2) converts leaf by leaf.
    Dense weights keep the reference's (in, out) layout (the port
    multiplies `x @ w`), so no leaf is transposed."""
    dev = resolve_device(device)
    axis = int(clients)
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if k == "segments":
            out[k] = [_unstack_layers(seg, axis, dev) for seg in v]
        else:
            out[k] = _map(v, lambda a: _tensor(a, dev))
    return out


def _unstack_layers(stacked, axis: int, dev):
    """A dict of leaves stacked on a layer axis (after `axis` client axes)
    -> one dict a layer, on `dev`."""
    return [_map(stacked, lambda a, i=i: _tensor(_take(a, i, axis), dev))
            for i in range(stacked["norm1"]["scale"].shape[axis])]


_ENCDEC_LAYERS = ("enc_layers", "dec_layers")


def encdec_params_from_jax(tree: Dict[str, Any], device=None,
                           clients: bool = False) -> Dict[str, Any]:
    """The reference's `encdec.init_encdec` pytree, its leaves numpy arrays
    (or CPU tensors) -> the port's encoder-decoder parameters
    (`models/encdec.py`) on `device`, same dtypes: `enc_layers` and
    `dec_layers`, stacked on a layer axis in the reference (after the
    client axis, with `clients`), become lists of per-layer dicts; every
    other leaf is copied as it is."""
    dev = resolve_device(device)
    axis = int(clients)
    return {k: (_unstack_layers(v, axis, dev) if k in _ENCDEC_LAYERS
                else _map(v, lambda a: _tensor(a, dev)))
            for k, v in tree.items()}


def encdec_params_to_numpy(params: Dict[str, Any],
                           clients: bool = False) -> Dict[str, Any]:
    """`encdec_params_from_jax` backwards: per-layer lists stacked on the
    layer axis (after the client axis, with `clients`), leaves on the
    host."""
    axis = int(clients)
    return {k: (_stack_layers(v, axis) if k in _ENCDEC_LAYERS
                else _map(v, _host))
            for k, v in params.items()}


def _host(t: torch.Tensor):
    """A tensor -> numpy on the host; a bfloat16 one stays a CPU tensor
    (numpy has no bfloat16; `checkpoint.save_pytree` writes it as the
    reference does)."""
    t = t.detach().cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def lm_params_to_numpy(params: Dict[str, Any],
                       clients: bool = False) -> Dict[str, Any]:
    """`lm_params_from_jax` backwards: per-layer lists stacked on the layer
    axis (after the client axis, with `clients`), leaves on the host."""
    axis = int(clients)
    out: Dict[str, Any] = {}
    for k, v in params.items():
        if k == "segments":
            out[k] = [_stack_layers(seg, axis) for seg in v]
        else:
            out[k] = _map(v, _host)
    return out


def _stack_layers(layers, axis: int):
    first = layers[0]
    if isinstance(first, dict):
        return {name: _stack_layers([lp[name] for lp in layers], axis)
                for name in first}
    return _host(torch.stack(layers, dim=axis))


def train_state_from_jax(state, device=None):
    """The reference's `TrainState` (its leaves numpy arrays, for example
    `jax.tree.map(np.asarray, state)`, or a checkpoint loaded onto
    `train_state_to_numpy`'s layout) -> the port's `launch.train.TrainState`
    on `device`: client-stacked LM (or encoder-decoder, told by its
    `enc_layers`) parameters and Adam moments, the (N,) Adam step, the
    ProtoState and the step."""
    from repro_torch.core.prototypes import ProtoState
    from repro_torch.launch.train import TrainState
    from repro_torch.optim import AdamState
    dev = resolve_device(device)
    from_jax = (encdec_params_from_jax if "enc_layers" in state.params
                else lm_params_from_jax)
    conv = lambda tree: from_jax(tree, dev, clients=True)
    opt = state.opt
    return TrainState(
        conv(state.params),
        AdamState(_tensor(opt.step, dev), conv(opt.m), conv(opt.v)),
        ProtoState(_tensor(state.proto.sum, dev),
                   _tensor(state.proto.count, dev)),
        _tensor(state.step, dev))


def train_state_to_numpy(state):
    """The port's `TrainState` -> the reference's layout, as the port's own
    NamedTuples (whose fields are the reference's) with host leaves: saved
    by `checkpoint.save_pytree`, its keys are the reference's
    `TrainState` paths."""
    from repro_torch.core.prototypes import ProtoState
    from repro_torch.launch.train import TrainState
    from repro_torch.optim import AdamState
    to_numpy = (encdec_params_to_numpy if "enc_layers" in state.params
                else lm_params_to_numpy)
    conv = lambda tree: to_numpy(tree, clients=True)
    return TrainState(conv(state.params),
                      AdamState(_host(state.opt.step), conv(state.opt.m),
                                conv(state.opt.v)),
                      ProtoState(_host(state.proto.sum),
                                 _host(state.proto.count)),
                      _host(state.step))


def relay_state_to_numpy(state) -> Dict[str, np.ndarray]:
    """Any relay policy's state (a NamedTuple of tensors) -> {field: numpy
    array}, field by field, as the reference's state holds them. A sharded
    state's inner fields come out flat, each (S, ...), beside `merges`."""
    out = {}
    for f in state._fields:
        v = getattr(state, f)
        if isinstance(v, tuple):
            out.update(relay_state_to_numpy(v))
        else:
            out[f] = v.detach().cpu().numpy()
    return out
