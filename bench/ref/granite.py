"""Plain reference of a decoder-only MoE LM as the configuration runs it
(Granite-3.0-1B-A400M: GQA attention with rotary positions, a top-k
softmax router with capacity-limited experts, SwiGLU experts, RMSNorm,
untied output head), and of the CoRS train step on it: L_CE + 0.01 x the
routers' balance loss + lambda_KD L_KD + lambda_disc L_disc (K sampled
negative classes), Adam, and the prototype merge.

Everything is computed in float32 from the weights the benchmark made
(bf16, the configuration's dtype); between steps the parameters are kept
in that dtype, as the configuration trains them. It imports nothing of
the program. `precision` rounds every product's operands (`fp8`: the
control a bf16 configuration is held against; `ref/precision.py`).

The MoE layer follows the configuration's capacity rule: in each row the
(token, choice) pairs, in token-major order, take positions in their
expert in that order, and pairs past ceil(cf * S * k / E) are dropped.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from ref.precision import operand

EPS = 1e-7


def _mm(a, b, prec):
    return operand(a, prec) @ operand(b, prec)


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x, theta):
    """x (B, S, h, hd): the two halves of each head rotated by position."""
    B, S, _, hd = x.shape
    half = hd // 2
    inv = theta ** (-2.0 * torch.arange(half, device=x.device,
                                        dtype=torch.float32) / hd)
    ang = torch.arange(S, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def attention(p, h, cfg, prec):
    B, S, d = h.shape
    H, G = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // H
    q = _mm(h, p["wq"].float(), prec).reshape(B, S, H, hd)
    k = _mm(h, p["wk"].float(), prec).reshape(B, S, G, hd)
    v = _mm(h, p["wv"].float(), prec).reshape(B, S, G, hd)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    # query head j reads key/value head j // (H / G)
    k = k.repeat_interleave(H // G, dim=2)
    v = v.repeat_interleave(H // G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", operand(q, prec),
                     operand(k, prec)) * (hd ** -0.5)
    mask = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    a = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
    o = torch.einsum("bhqk,bkhd->bqhd", operand(a, prec), operand(v, prec))
    return _mm(o.reshape(B, S, H * hd), p["wo"].float(), prec)


def moe(p, h, cfg, prec):
    """-> (y, balance loss). Routing in float32, capacity per row."""
    B, S, d = h.shape
    E, k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    cap = max(1, int(math.ceil(cfg["capacity_factor"] * S * k / E)))
    probs = torch.softmax(_mm(h, p["router"].float(), prec), -1)  # (B,S,E)
    top_p, top_i = torch.topk(probs, k, dim=-1, sorted=True)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    hits = F.one_hot(top_i, E).float().sum(2)                     # (B,S,E)
    aux = E * (probs.mean((0, 1)) * (hits.mean((0, 1)) / k)).sum()
    # each pair's position in its expert, row by row, in token-major order
    flat = top_i.reshape(B, S * k)
    onehot = F.one_hot(flat, E)                                   # (B,Sk,E)
    pos = ((onehot.cumsum(1) - 1) * onehot).sum(-1)
    kept = pos < cap
    wflat = top_p.reshape(B, S * k)
    hflat = h.reshape(B * S, d)
    y = torch.zeros_like(hflat)
    for e in range(E):
        b, pair = ((flat == e) & kept).nonzero(as_tuple=True)
        if b.numel() == 0:
            continue
        tok = b * S + pair // k
        x = hflat[tok]
        g = _mm(x, p["w_gate_e"][e].float(), prec)
        u = _mm(x, p["w_up_e"][e].float(), prec)
        out = _mm(F.silu(g) * u, p["w_down_e"][e].float(), prec)
        y = y.index_add(0, tok, out * wflat[b, pair][:, None])
    y = y.reshape(B, S, d)
    return y, aux


def forward(params, tokens, cfg, prec="float32", last_only=False):
    """tokens (B, S) -> features (B, S, d) and logits (B, S, V) float32
    (with `last_only`, the last position's (B, 1, V)), and the summed
    balance loss."""
    eps = cfg["rms_norm_eps"]
    x = params["embed"].float()[tokens.long()]
    aux = 0.0
    for lp in params["segments"][0]:
        h = rmsnorm(x, lp["norm1"]["scale"], eps)
        x = x + attention(lp["attn"], h, cfg, prec)
        h = rmsnorm(x, lp["norm2"]["scale"], eps)
        y, a = moe(lp["moe"], h, cfg, prec)
        x = x + y
        aux = aux + a
    f = rmsnorm(x, params["final_norm"]["scale"], eps)
    if last_only:
        f = f[:, -1:]
    return f, _mm(f, params["lm_head"].float(), prec), aux


def prefill_logits(params, tokens, cfg, prec="float32"):
    """The last position's logits (B, V) of each prompt."""
    with torch.no_grad():
        f, z, _ = forward(params, tokens, cfg, prec, last_only=True)
    return z[:, -1]


# ---------------------------------------------------------------------------
# the CoRS train step
# ---------------------------------------------------------------------------
def disc_sampled(neg, f, z, protos, y, head, prec):
    p = torch.softmax(z, -1)
    zp = torch.softmax(_mm(protos[y], head, prec), -1)
    zn = torch.softmax(_mm(protos[neg], head, prec), -1)
    h_pos = (p * zp).sum(-1).clamp(EPS, 1 - EPS)
    h_neg = _mm(p, zn.T, prec).clamp(EPS, 1 - EPS)
    not_self = (neg[None, :] != y[:, None]).float()
    return (-torch.log(h_pos)
            - (torch.log1p(-h_neg) * not_self).sum(-1)).mean()


def client_loss(params, tokens, labels, neg, proto_means, cfg, tr, prec):
    f, z, aux = forward(params, tokens, cfg, prec)
    V = z.shape[-1]
    f2, z2, y2 = f.reshape(-1, f.shape[-1]), z.reshape(-1, V), \
        labels.reshape(-1).long()
    ce = F.cross_entropy(z2, y2)
    total = ce + cfg["router_aux_loss_coef"] * aux
    kd = ((f2 - proto_means[y2]) ** 2).mean(-1).mean()
    T = min(tr["disc_tokens"], f2.shape[0])
    disc = disc_sampled(neg.long(), f2[:T], z2[:T], proto_means, y2[:T],
                        params["lm_head"].float(), prec)
    total = total + tr["lambda_kd"] * kd + tr["lambda_disc"] * disc
    return total, f2.detach(), y2


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _paths(tree[k], f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _set(tree, path, value):
    parts = path.split("/")
    for p in parts[:-1]:
        tree = tree[int(p)] if isinstance(tree, list) else tree[p]
    tree[parts[-1]] = value


def _client(tree, i):
    if isinstance(tree, dict):
        return {k: _client(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_client(v, i) for v in tree]
    return tree[i]


def train_steps(params, batches: List[Dict], negs, cfg, tr,
                steps: int, prec="float32") -> Dict:
    """params: every leaf (N, ...) in the configuration's dtype (taken
    over: updated in place of the caller's tree). batches[t]: tokens and
    labels (N, B, S); negs[t]: (N, K). -> each step's mean total loss,
    the first step's gradient norms by leaf (over all clients), the
    parameters after `steps` (the caller's tree, updated), the merged
    prototype sums and counts."""
    N = next(iter(_paths(params)))[1].shape[0]
    V, d = cfg["vocab_size"], cfg["hidden_size"]
    dev = params["lm_head"].device
    b1, b2, eps, lr = tr["beta1"], tr["beta2"], tr["eps"], tr["lr"]
    mom = {i: {} for i in range(N)}
    stacked = dict(_paths(params))
    psum = torch.zeros(V, d, device=dev)
    pcnt = torch.zeros(V, device=dev)
    out = {"loss": []}
    for t in range(steps):
        means = psum / pcnt.clamp(min=1.0)[:, None]
        losses, feats, labs, gsq = [], [], [], {}
        for i in range(N):
            cp = _client(params, i)
            leaves = [(k, v.float().requires_grad_(True))
                      for k, v in _paths(cp)]
            work = _client(params, i)
            for k, v in leaves:
                _set(work, k, v)
            total, f, y = client_loss(work, batches[t]["tokens"][i],
                                      batches[t]["labels"][i], negs[t][i],
                                      means, cfg, tr, prec)
            grads = torch.autograd.grad(total, [v for _, v in leaves])
            losses.append(float(total.detach()))
            feats.append(f)
            labs.append(y)
            bc1 = 1 - torch.tensor(b1) ** (t + 1)
            bc2 = 1 - torch.tensor(b2) ** (t + 1)
            for (k, v), g in zip(leaves, grads):
                if t == 0:
                    gsq[k] = gsq.get(k, 0.0) + float((g * g).sum())
                m, s = mom[i].get(k, (torch.zeros_like(g),
                                      torch.zeros_like(g)))
                m = b1 * m + (1 - b1) * g
                s = b2 * s + (1 - b2) * g * g
                mom[i][k] = (m, s)
                u = (m / bc1.to(dev)) / (torch.sqrt(s / bc2.to(dev)) + eps)
                stacked[k][i] = (v.detach() - lr * u).to(stacked[k].dtype)
            del leaves, work, grads, total
        out["loss"].append(sum(losses) / N)
        if t == 0:
            out["grad_norms"] = {k: math.sqrt(v) for k, v in gsq.items()}
        for f, y in zip(feats, labs):
            psum.index_add_(0, y, f)
            pcnt += torch.bincount(y, minlength=V).float()
        del feats, labs
    out["proto_sum"], out["proto_count"] = psum, pcnt
    out["params"] = params
    return out
