"""Functional Adam (the paper's optimizer, lr 1e-3); the port of the Adam
part of `repro/optim/optim.py`, in the reference's operation order
(m/bc1)/(sqrt(v/bc2)+eps). State mirrors the parameter dict.

The step count is an int32 tensor on the parameters' device: 0-d for one
client, (N,) for a stack of N clients (the reference's stacked per-client
`AdamState`s), so every client of a stack keeps its own bias corrections
and a client that skips a round keeps its count. The corrections are
computed on the device, with no host read."""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch


class AdamState(NamedTuple):
    step: torch.Tensor               # int32, () or (N,)
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


def adam_init(params: Dict[str, torch.Tensor],
              clients: Optional[int] = None) -> AdamState:
    """Zero moments; step 0-d, or (clients,) for stacked parameters whose
    leading axis holds `clients` clients."""
    dev = next(iter(params.values())).device
    step = torch.zeros(() if clients is None else (clients,),
                       dtype=torch.int32, device=dev)
    return AdamState(step, {k: torch.zeros_like(p, dtype=torch.float32)
                            for k, p in params.items()},
                     {k: torch.zeros_like(p, dtype=torch.float32)
                      for k, p in params.items()})


def adam_update(params, grads, state: AdamState, *, lr=1e-3, b1=0.9,
                b2=0.999, eps=1e-8):
    """-> (new params, new state). Pure: inputs are not modified. The bias
    corrections are float32, as in the reference (`b1 ** t` with t f32),
    one per client, broadcast against each leaf's client axis."""
    step = state.step + 1
    t = step.float()
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k].float()
        m = b1 * state.m[k] + (1 - b1) * g
        v = b2 * state.v[k] + (1 - b2) * torch.square(g)
        lead = bc1.shape + (1,) * (p.dim() - bc1.dim())
        u = (m / bc1.reshape(lead)) / (torch.sqrt(v / bc2.reshape(lead)) + eps)
        new_p[k] = (p.float() - lr * u).to(p.dtype)
        new_m[k], new_v[k] = m, v
    return new_p, AdamState(step, new_m, new_v)
