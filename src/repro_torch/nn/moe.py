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
mean probabilities, as in the reference.

On a mesh (DTensor parameters) the router and the aux propagate as DTensor
ops, with the reference's sharding hints at its points
(`sharding.constrain` of the dispatch buffer and the expert outputs: over
experts under "moe_ep", batch-local under "moe_dp"). Under "moe_ep" the
expert weights are split on their expert dim over "model"
(`sharding.layer_spec`, which departs from the reference's stacked spec
there), so each rank holds E / model experts and `_experts` runs its
expert-split branch on its own block of the buffer; `combine` then
gathers each batch row's outputs whole over "model". The top-k (its
backward scatters, which PyTorch 2.11's DTensor mixes a plain tensor
into), the dispatch (one-hot cumsum and `scatter_add_`, which have no
DTensor sharding rule) and the combine (a gather by slot) are token- or
row-local, so they run on each rank's batch rows through `local_map`
(`sharding.local_rows`); the expert products too (`_experts`), with the gradients'
placements declared.

Stacked expert weight names end in `_e`, as in the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import sharding
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
    E = router_w.shape[-1]
    top_p, top_i, hits = sharding.local_rows(
        lambda p: _top_k(p, k, E), 3, probs)
    me = probs.mean(dim=(0, 1))                               # mean prob/expert
    ce = hits.mean(dim=(0, 1)) / k
    aux = E * torch.sum(me * ce)
    return top_p, top_i, aux


def _top_k(probs, k: int, E: int):
    """Each token's top-k experts (descending), their renormalised
    probabilities and its one-hot hits (B, S, E): token-local."""
    top_p, top_i = torch.topk(probs, k, dim=-1, sorted=True)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return top_p, top_i, F.one_hot(top_i, E).float().sum(2)


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


def experts(buf, w_gate, w_up, w_down):
    """buf (B, E, cap, d) through each expert's SwiGLU -> (B, E, cap, d)."""
    g = torch.einsum("becd,edf->becf", buf, w_gate)
    u = torch.einsum("becd,edf->becf", buf, w_up)
    return torch.einsum("becf,efd->becd", F.silu(g) * u, w_down)


def _experts(buf, w_gate, w_up, w_down):
    """`experts`, on each rank's shard when buf is a DTensor, through
    `local_map` (DTensor's own backward of these einsums over a split ffn
    dim fails on a non-contiguous view). On each mesh dim, by the weights'
    placements: the ffn dim split (`Shard(2)`, `Shard(2)`, `Shard(1)`, "tp")
    takes the buffer whole and gives a `Partial` sum; the experts split
    (`Shard(0)`, "moe_ep") takes the buffer split on experts and gives it
    so; otherwise the weights are made whole, and the buffer keeps a batch
    split."""
    if not sharding.is_dtensor(buf):
        return experts(buf, w_gate, w_up, w_down)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = buf.device_mesh
    # per mesh dim: placements of (buf, w_gate, w_up, w_down), of the
    # output, and of the four gradients
    ins, outs, grads = [], [], []
    for i in range(mesh.ndim):
        have = (w_gate.placements[i], w_up.placements[i],
                w_down.placements[i])
        if have == (Shard(2), Shard(2), Shard(1)):
            # whole rows, a slice of the ffn dim: the rank's share of the
            # output and of buf's gradient is a partial sum
            ins.append((Replicate(),) + have)
            outs.append(Partial())
            grads.append((Partial(),) + have)
        elif have == (Shard(0),) * 3:
            ins.append((Shard(1),) + have)
            outs.append(Shard(1))
            grads.append(ins[-1])
        else:
            b = Shard(0) if buf.placements[i] == Shard(0) else Replicate()
            ins.append((b,) + (Replicate(),) * 3)
            outs.append(b)
            # the weights' gradients from a rank's rows are partial sums
            wg = Partial() if b == Shard(0) else Replicate()
            grads.append((b,) + (wg,) * 3)
    col = lambda rows, j: tuple(r[j] for r in rows)
    args = [t.redistribute(mesh, col(ins, j))
            for j, t in enumerate((buf, w_gate, w_up, w_down))]
    return local_map(experts, out_placements=(tuple(outs),),
                     in_placements=tuple(col(ins, j) for j in range(4)),
                     in_grad_placements=tuple(col(grads, j)
                                              for j in range(4)),
                     device_mesh=mesh)(*args)


def combine(out, slot, top_p, valid):
    """out (B, E*cap, d) expert outputs; slot, top_p, valid (B, S, k) -> y
    (B, S, d): each token's k outputs gathered back and weighted (0 for a
    dropped pair)."""
    B, S, k = slot.shape
    d = out.shape[-1]
    safe = torch.clamp(slot.reshape(B, S * k), max=out.shape[1] - 1)
    y_k = out.gather(1, safe[..., None].expand(B, S * k, d)).reshape(
        B, S, k, d)
    w = (top_p * valid.to(top_p.dtype))[..., None].to(y_k.dtype)
    return (y_k * w).sum(2)


def moe_block(p, x, *, num_experts: int, k: int, cf: float,
              num_shared: int):
    """x (B,S,d) -> (y (B,S,d), aux_loss f32)."""
    B, S, d = x.shape
    E = num_experts
    cap = capacity(S, k, E, cf)
    top_p, top_i, aux = route(p["router"], x, k)
    buf, slot, valid = sharding.local_rows(
        lambda a, b: dispatch(a, b, cap, E), 3, x, top_i)
    buf = buf.reshape(B, E, cap, d)
    if sharding.hint("moe_ep"):
        # expert-parallel: dispatch buffer and expert compute sharded over
        # experts on the model axis
        buf = sharding.constrain(buf, "data", "model", None, None)
    elif sharding.hint("moe_dp"):
        # dp_only/zero1: keep the dispatch fully batch-local
        buf = sharding.constrain(buf, ("data", "model"), None, None, None)
    out = _experts(buf, p["w_gate_e"], p["w_up_e"], p["w_down_e"])
    if sharding.hint("moe_ep"):
        out = sharding.constrain(out, "data", "model", None, None)
    elif sharding.hint("moe_dp"):
        out = sharding.constrain(out, ("data", "model"), None, None, None)
    y = sharding.local_rows(combine, 1, out.reshape(B, E * cap, d), slot,
                            top_p, valid)
    if num_shared:
        y = y + layers.swiglu(p["shared"], x)
    return y, aux.float()
