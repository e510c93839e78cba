"""Mixture-of-Experts layer, the port of `repro/nn/moe.py`: a top-k router
and capacity-based dispatch.

The router runs in float32 and its scores are softmaxed; the top-k
probabilities are renormalised; the aux loss is Switch's load-balance
loss, E * sum(me * ce). Dispatch follows the reference: each batch row
gives every (token, choice) pair, in the flattened (S * k) order, a
position in its expert by a cumsum of one-hots; pairs past the capacity go
to a dump row and come back with weight 0. The reference's `jax.vmap` over
batch rows becomes a batch axis written out, its `.at[slot].add` a
`scatter_add_` (every kept slot receives exactly one value, so the add is
exact). The expert products are batched matrix products over the stacked
(E, d, f) weights, as the reference's `jnp.einsum`s outside any Pallas
kernel. Train mode runs the same code under autograd: the router's
softmax and top-k, the `scatter_add_` into a fresh buffer (gathered back in
the backward) and the aux, whose gradient reaches the router through the
mean probabilities, as in the reference. The reference's sharding hints
come with the multi-device slice.

Stacked expert weight names end in `_e`, as in the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.nn import layers


def init_moe(gen, d_model: int, num_experts: int, moe_d_ff: int,
             num_shared: int, dtype):
    E, f = num_experts, moe_d_ff
    scale = 1.0 / math.sqrt(d_model)
    dev = layers.gen_device(gen)

    def stacked(d_in, d_out, s):
        return (torch.randn(E, d_in, d_out, generator=gen, device=dev)
                * s).to(dtype)

    p = {
        "router": layers.dense_init(gen, d_model, E, torch.float32,
                                    scale=scale),
        "w_gate_e": stacked(d_model, f, scale),
        "w_up_e": stacked(d_model, f, scale),
        "w_down_e": stacked(f, d_model, 1.0 / math.sqrt(f)),
    }
    if num_shared:
        p["shared"] = layers.init_swiglu(gen, d_model, moe_d_ff * num_shared,
                                         dtype)
    return p


def capacity(seq: int, k: int, num_experts: int, cf: float) -> int:
    return max(1, int(math.ceil(cf * seq * k / num_experts)))


def route(router_w, x, k: int):
    """x (B,S,d) -> probs (B,S,k) f32, idx (B,S,k) int64 (descending
    probability, as `jax.lax.top_k`), aux_loss scalar f32."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)                     # (B,S,E)
    top_p, top_i = torch.topk(probs, k, dim=-1, sorted=True)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    E = router_w.shape[-1]
    me = probs.mean(dim=(0, 1))                               # mean prob/expert
    ce = F.one_hot(top_i, E).float().sum(2).mean(dim=(0, 1)) / k
    aux = E * torch.sum(me * ce)
    return top_p, top_i, aux


def dispatch(x, top_i, cap: int, E: int):
    """x (B,S,d); top_i (B,S,k) -> buffer (B, E*cap, d), slot (B,S,k) in
    [0, E*cap] (E*cap: dropped), valid (B,S,k) bool. The reference's
    `_dispatch_row` for every batch row at once."""
    B, S, k = top_i.shape
    flat = top_i.reshape(B, S * k)
    onehot = F.one_hot(flat, E)                               # (B, S*k, E)
    pos = ((torch.cumsum(onehot, dim=1) - 1) * onehot).sum(-1)
    valid = pos < cap
    slot = torch.where(valid, flat * cap + pos,
                       torch.full_like(flat, E * cap))        # overflow -> dump
    d = x.shape[-1]
    buf = x.new_zeros(B, E * cap + 1, d)
    vals = x.repeat_interleave(k, dim=1)                      # (B, S*k, d)
    buf.scatter_add_(1, slot[..., None].expand(B, S * k, d), vals)
    return buf[:, :-1], slot.reshape(B, S, k), valid.reshape(B, S, k)


def moe_block(p, x, *, num_experts: int, k: int, cf: float,
              num_shared: int):
    """x (B,S,d) -> (y (B,S,d), aux_loss f32)."""
    B, S, d = x.shape
    E = num_experts
    cap = capacity(S, k, E, cf)
    top_p, top_i, aux = route(p["router"], x, k)
    buf, slot, valid = dispatch(x, top_i, cap, E)
    buf = buf.reshape(B, E, cap, d)
    g = torch.einsum("becd,edf->becf", buf, p["w_gate_e"])
    u = torch.einsum("becd,edf->becf", buf, p["w_up_e"])
    out = torch.einsum("becf,efd->becd", F.silu(g) * u, p["w_down_e"])
    out = out.reshape(B, E * cap, d)
    safe = torch.clamp(slot.reshape(B, S * k), max=E * cap - 1)
    y_k = out.gather(1, safe[..., None].expand(B, S * k, d)).reshape(
        B, S, k, d)
    w = (top_p * valid.to(top_p.dtype))[..., None].to(y_k.dtype)
    y = (y_k * w).sum(2)
    if num_shared:
        y = y + layers.swiglu(p["shared"], x)
    return y, aux.float()
