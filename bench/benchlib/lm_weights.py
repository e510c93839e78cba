"""A decoder-only MoE LM's random weights, made on the device from a seed
in one call a kind of leaf (every layer's, every client's at once), in the
dtype the configuration runs in, laid out as the port's parameter tree
(`models/lm.py`: `embed`, `segments` [[layer dicts]], `final_norm`,
`lm_head`). The distributions are the port's own inits: N(0, 1/fan_in)
products, embeddings N(0, 0.02^2), the router in float32, norms at one.
The plain reference reads the same tree."""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch


def dims(cfg: Dict):
    d = cfg["hidden_size"]
    H, G = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // H
    return d, H, G, hd


def make(cfg: Dict, seed: int, device, clients: Optional[int] = None):
    """-> the parameter tree; with `clients` = N every leaf leads with a
    client axis (each client its own draw)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    dt = getattr(torch, cfg["torch_dtype"])
    d, H, G, hd = dims(cfg)
    L, V = cfg["num_hidden_layers"], cfg["vocab_size"]
    E, f = cfg["num_local_experts"], cfg["intermediate_size"]
    lead = () if clients is None else (clients,)

    def draw(shape, scale, dtype=dt):
        # one call for all layers: (L, *lead, *shape), each [l] contiguous
        t = torch.randn((L,) + lead + tuple(shape), generator=gen,
                        device=device)
        return t.mul_(scale).to(dtype)

    wq = draw((d, H * hd), 1 / math.sqrt(d))
    wk = draw((d, G * hd), 1 / math.sqrt(d))
    wv = draw((d, G * hd), 1 / math.sqrt(d))
    wo = draw((H * hd, d), 1 / math.sqrt(H * hd))
    router = draw((d, E), 1 / math.sqrt(d), torch.float32)
    gate = draw((E, d, f), 1 / math.sqrt(d))
    up = draw((E, d, f), 1 / math.sqrt(d))
    down = draw((E, f, d), 1 / math.sqrt(f))
    one = torch.ones(lead + (d,), dtype=dt, device=device)
    layers = [{"norm1": {"scale": one.clone()},
               "attn": {"wq": wq[l], "wk": wk[l], "wv": wv[l], "wo": wo[l]},
               "norm2": {"scale": one.clone()},
               "moe": {"router": router[l], "w_gate_e": gate[l],
                       "w_up_e": up[l], "w_down_e": down[l]}}
              for l in range(L)]
    emb = torch.randn(lead + (V, d), generator=gen, device=device)
    head = torch.randn(lead + (d, V), generator=gen, device=device)
    return {"embed": emb.mul_(0.02).to(dt), "segments": [layers],
            "final_norm": {"scale": one.clone()},
            "lm_head": head.mul_(1 / math.sqrt(d)).to(dt)}


def leaves(tree, prefix=""):
    """(path, tensor) of every leaf, in a fixed order."""
    if isinstance(tree, dict):
        for k in tree:
            yield from leaves(tree[k], f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree

