"""Optimizers, the port of `repro/optim/optim.py`: Adam (the paper's
optimizer, lr 1e-3) in the reference's operation order
(m/bc1)/(sqrt(v/bc2)+eps), SGD with optional momentum, global-norm
clipping and the cosine schedule.

State mirrors the parameter tree (dicts and lists, such as an LM's
`segments` list of per-layer dicts; `tree.tree_map`). Moments and momentum
buffers are float32; each update computes in float32 and casts back to the
parameter's dtype, as the reference does. Adam's step count is an int32
tensor on the parameters' device: 0-d for one client, (N,) for a stack of
N clients (the reference's stacked per-client `AdamState`s), so every
client of a stack keeps its own bias corrections and a client that skips a
round keeps its count. The corrections are computed on the device, with
no host read."""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.tree import leaves, tree_map


class AdamState(NamedTuple):
    step: torch.Tensor               # int32, () or (N,)
    m: Any
    v: Any


def _zeros32(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def adam_init(params, clients: Optional[int] = None) -> AdamState:
    """Zero moments; step 0-d, or (clients,) for stacked parameters whose
    leading axis holds `clients` clients."""
    dev = leaves(params)[0].device
    step = torch.zeros(() if clients is None else (clients,),
                       dtype=torch.int32, device=dev)
    return AdamState(step, _zeros32(params), _zeros32(params))


def adam_update(params, grads, state: AdamState, *, lr=1e-3, b1=0.9,
                b2=0.999, eps=1e-8):
    """-> (new params, new state). Pure: inputs are not modified. The bias
    corrections are float32, as in the reference (`b1 ** t` with t f32),
    one per client, broadcast against each leaf's client axis."""
    step = state.step + 1
    t = step.float()
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t

    def upd(p, g, m, v):
        g = g.float()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        lead = bc1.shape + (1,) * (p.dim() - bc1.dim())
        u = (m / bc1.reshape(lead)) / (torch.sqrt(v / bc2.reshape(lead)) + eps)
        return (p.float() - lr * u).to(p.dtype), m, v

    out = tree_map(upd, params, grads, state.m, state.v)
    pick = lambda i: tree_map(lambda p, o: o[i], params, out)
    return pick(0), AdamState(step, pick(1), pick(2))


class SgdState(NamedTuple):
    momentum: Any                    # None without momentum


def sgd_init(params, momentum: float = 0.0) -> SgdState:
    if momentum == 0.0:
        return SgdState(None)
    return SgdState(_zeros32(params))


def sgd_update(params, grads, state: SgdState, *, lr=1e-2, momentum=0.0):
    if momentum and state.momentum is not None:
        buf = tree_map(lambda b, g: momentum * b + g.float(), state.momentum,
                       grads)
        new = tree_map(lambda p, b: (p.float() - lr * b).to(p.dtype),
                       params, buf)
        return new, SgdState(buf)
    new = tree_map(lambda p, g: (p.float() - lr * g.float()).to(p.dtype),
                   params, grads)
    return new, state


def clip_by_global_norm(grads, max_norm: float):
    """-> (grads scaled to a global norm of at most max_norm, the norm as a
    0-d float32 tensor); no host read."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                        for g in leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn


def cosine_schedule(step, *, base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1):
    """Linear warm-up, then cosine decay to min_frac * base_lr; `step` a
    tensor on the device, never read on the host."""
    t = step.float()
    warm = base_lr * t / max(1.0, float(warmup))
    prog = torch.clamp((t - warmup) / max(1.0, float(total - warmup)),
                       0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(t < warmup, warm, cos)
