"""Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3), the port of
`repro/nn/mla.py`, in its two forms:
  - expanded (prefill): the latent kv is up-projected to per-head (k_nope,
    v), and self-attention runs through the prefill attention of
    `nn/attention.py` (the flash kernel on the card, at MLA's split head
    dims: queries and keys qk_nope + qk_rope wide, values v_head_dim);
  - absorbed (decode): W_uk is absorbed into the query and W_uv into the
    output, so attention runs in float32 directly against the compressed
    latent cache (B, S, kv_lora + qk_rope).
`k_rope` is one rotated head, (B, S, 1, dr), with kind "rope" whatever
`cfg.rope_kind` says, broadcast to every head before attention. In train
mode the expanded form attends with the plain functions under autograd by
the reference's own rule (`mla.py:78-82`): `full_attention` when S <= 2 *
chunk, else `chunked_attention`.
"""
from __future__ import annotations

import torch

from repro_torch.nn import attention, layers, rope as rope_lib


def init_mla(gen, cfg, dtype):
    d = cfg.d_model
    H = cfg.num_heads
    r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dev = layers.gen_device(gen)
    p = {}
    if r_q:
        p["wq_a"] = layers.dense_init(gen, d, r_q, dtype)
        p["q_norm"] = layers.init_rmsnorm(r_q, dtype, dev)
        p["wq_b"] = layers.dense_init(gen, r_q, H * (dn + dr), dtype)
    else:
        p["wq_b"] = layers.dense_init(gen, d, H * (dn + dr), dtype)
    p["wkv_a"] = layers.dense_init(gen, d, r_kv + dr, dtype)
    p["kv_norm"] = layers.init_rmsnorm(r_kv, dtype, dev)
    p["wkv_b"] = layers.dense_init(gen, r_kv, H * (dn + dv), dtype)
    p["wo"] = layers.dense_init(gen, H * dv, d, dtype)
    return p


def _queries(p, cfg, x):
    B, S, _ = x.shape
    H, dn, dr = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    if cfg.q_lora_rank:
        cq = layers.rmsnorm(p["q_norm"], x @ p["wq_a"], cfg.norm_eps)
        q = cq @ p["wq_b"]
    else:
        q = x @ p["wq_b"]
    q = q.reshape(B, S, H, dn + dr)
    return q[..., :dn], q[..., dn:]       # q_nope (B,S,H,dn), q_rope (B,S,H,dr)


def _latent_kv(p, cfg, x, positions):
    """-> c_kv (B,S,r_kv) normalized, k_rope (B,S,1,dr) rotated."""
    r_kv = cfg.kv_lora_rank
    kv = x @ p["wkv_a"]
    c_kv = layers.rmsnorm(p["kv_norm"], kv[..., :r_kv], cfg.norm_eps)
    k_rope = rope_lib.apply_rope(kv[..., r_kv:][:, :, None, :], positions,
                                 theta=cfg.rope_theta, kind="rope")
    return c_kv, k_rope


def mla_block(p, cfg, x, positions, *, window: int = 0, chunk: int = 512,
              return_cache: bool = False, mode: str = "prefill"):
    """Expanded-form MLA over a full sequence -> y (B,S,d) [, cache
    (B,S,r_kv+dr)]; `mode` "train" attends with the plain functions, any
    other mode with the prefill kernel."""
    if window and mode != "train":
        raise NotImplementedError(
            "sliding-window prefill is not ported yet: the flash kernel has "
            "no window (ROADMAP.md, queue 1: sliding-window prefill)")
    B, S, _ = x.shape
    H, dn, dr, dv = (cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    q_nope, q_rope = _queries(p, cfg, x)
    q_rope = rope_lib.apply_rope(q_rope, positions, theta=cfg.rope_theta,
                                 kind="rope")
    c_kv, k_rope = _latent_kv(p, cfg, x, positions)
    kv = (c_kv @ p["wkv_b"]).reshape(B, S, H, dn + dv)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([kv[..., :dn], k_rope.expand(B, S, H, dr)], dim=-1)
    v = kv[..., dn:]
    if mode != "train":
        o = attention._prefill_attention(q, k, v, causal=True)
    elif S <= 2 * chunk:
        o = attention.full_attention(q, k, v, causal=True, window=window)
    else:
        o = attention.chunked_attention(q, k, v, causal=True, window=window,
                                        chunk=chunk)
    y = o.reshape(B, S, H * dv) @ p["wo"]
    if return_cache:
        return y, torch.cat([c_kv, k_rope[:, :, 0, :]], dim=-1)
    return y


def mla_decode(p, cfg, x, cache, positions, *, cache_index=None,
               masked: bool = False):
    """Absorbed-form one-token decode against the latent cache (B, Sc,
    r_kv + dr). The new entry is written IN PLACE at slot `cache_index`
    (default: the last); with `masked=True` attention covers slots <=
    cache_index. Returns (y, cache)."""
    B = x.shape[0]
    H, dn, dr, dv = (cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    r_kv = cfg.kv_lora_rank
    q_nope, q_rope = _queries(p, cfg, x)                      # (B,1,H,.)
    q_rope = rope_lib.apply_rope(q_rope, positions, theta=cfg.rope_theta,
                                 kind="rope")
    c_new, kr_new = _latent_kv(p, cfg, x, positions)
    Sc = cache.shape[1]
    idx = Sc - 1 if cache_index is None else int(cache_index)
    cache[:, idx] = torch.cat([c_new, kr_new[:, :, 0, :]],
                              dim=-1)[:, 0].to(cache.dtype)
    c_kv, k_rope = cache[..., :r_kv].float(), cache[..., r_kv:].float()

    w_b = p["wkv_b"].reshape(r_kv, H, dn + dv).float()
    w_uk, w_uv = w_b[..., :dn], w_b[..., dn:]                 # (r,H,dn),(r,H,dv)
    # absorb: the latent-space query q_lat[h] = q_nope[h] @ W_uk[:, h, :]^T
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope.float(), w_uk)
    s = (torch.einsum("bshr,bkr->bhsk", q_lat, c_kv)
         + torch.einsum("bshd,bkd->bhsk", q_rope.float(), k_rope)
         ) * (dn + dr) ** -0.5                                # (B,H,1,Sc)
    if masked:
        valid = torch.arange(Sc, device=x.device) <= idx
        s = s.masked_fill(~valid[None, None, None, :], attention.NEG_INF)
    w = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhsk,bkr->bshr", w, c_kv)
    o = torch.einsum("bshr,rhd->bshd", o_lat, w_uv)
    y = o.reshape(B, 1, H * dv).to(x.dtype) @ p["wo"]
    return y, cache
