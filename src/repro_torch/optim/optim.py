"""Functional Adam (the paper's optimizer, lr 1e-3); the port of the Adam
part of `repro/optim/optim.py`, in the reference's operation order
(m/bc1)/(sqrt(v/bc2)+eps). State mirrors the parameter dict."""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch


class AdamState(NamedTuple):
    step: int
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


def adam_init(params: Dict[str, torch.Tensor]) -> AdamState:
    return AdamState(0, {k: torch.zeros_like(p, dtype=torch.float32)
                         for k, p in params.items()},
                     {k: torch.zeros_like(p, dtype=torch.float32)
                      for k, p in params.items()})


def adam_update(params, grads, state: AdamState, *, lr=1e-3, b1=0.9,
                b2=0.999, eps=1e-8):
    """-> (new params, new state). Pure: inputs are not modified. The bias
    corrections are float32, as in the reference (`b1 ** t` with t f32)."""
    step = state.step + 1
    t = torch.tensor(float(step), dtype=torch.float32)
    bc1 = (1 - b1 ** t).item()
    bc2 = (1 - b2 ** t).item()
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k].float()
        m = b1 * state.m[k] + (1 - b1) * g
        v = b2 * state.v[k] + (1 - b2) * torch.square(g)
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        new_p[k] = (p.float() - lr * u).to(p.dtype)
        new_m[k], new_v[k] = m, v
    return new_p, AdamState(step, new_m, new_v)
