"""GQA attention, the port of `repro/nn/attention.py`: prefill through the
hand-written flash kernel, decode as plain PyTorch ops.

`gqa_block` sends its self-attention (`kv is None`, `window == 0`) to
`kernels.ops.flash_attention`: the CUDA kernel for tensors on the card, its
plain version for tensors on the CPU. On the causal, `q_offset = 0` serving
path that is the function the reference computes with `full_attention` or
`chunked_attention` (`attention.py:134-137`). Cross-attention and sliding
windows raise `NotImplementedError`; nothing is routed quietly to a plain
path on the card. `full_attention` and `chunked_attention` are kept as the
reference's plain functions (decode uses `full_attention`).

Layouts: x (B, S, D); q (B, S, H, hd); k/v (B, S, G, hd) with G = KV heads.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import ops
from repro_torch.nn import layers, rope as rope_lib

NEG_INF = -1e30

# What gqa_block's self-attention calls; `prefill_attention` swaps it.
_prefill_attention = ops.flash_attention


@contextlib.contextmanager
def prefill_attention(fn):
    """Run gqa_block's self-attention through `fn(q, k, v, causal=...)`
    instead of the kernel inside the `with` block (for a check that holds the
    kernel path against its plain version through a whole model)."""
    global _prefill_attention
    before = _prefill_attention
    _prefill_attention = fn
    try:
        yield
    finally:
        _prefill_attention = before


def init_gqa(gen: torch.Generator, d_model: int, num_heads: int,
             num_kv_heads: int, head_dim: int, dtype):
    return {
        "wq": layers.dense_init(gen, d_model, num_heads * head_dim, dtype),
        "wk": layers.dense_init(gen, d_model, num_kv_heads * head_dim, dtype),
        "wv": layers.dense_init(gen, d_model, num_kv_heads * head_dim, dtype),
        "wo": layers.dense_init(gen, num_heads * head_dim, d_model, dtype),
    }


def qkv(params, x, num_heads: int, num_kv_heads: int, head_dim: int):
    B, S, _ = x.shape
    q = (x @ params["wq"]).reshape(B, S, num_heads, head_dim)
    k = (x @ params["wk"]).reshape(B, S, num_kv_heads, head_dim)
    v = (x @ params["wv"]).reshape(B, S, num_kv_heads, head_dim)
    return q, k, v


def _mask(Sq, Sk, causal, window, q_offset, device, k0=0):
    q_pos = q_offset + torch.arange(Sq, device=device)
    k_pos = k0 + torch.arange(Sk, device=device)
    mask = torch.ones(Sq, Sk, dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    return mask[None, None, :, None, :]


def _scaled_q(q, G):
    """(B, Sq, H, hd) -> (B, Sq, G, H/G, hd) float32, scaled by hd^-0.5 in
    q's dtype first, as the reference does."""
    B, Sq, H, hd = q.shape
    return (q.reshape(B, Sq, G, H // G, hd) * (hd ** -0.5)).float()


def chunked_attention(q, k, v, *, causal: bool, window: int = 0,
                      chunk: int = 512, q_offset: int = 0):
    """q (B,Sq,H,hd); k,v (B,Sk,G,hd) -> (B,Sq,H,hd): a loop over KV chunks
    with a running (max, sum, acc), memory bounded by one (B,G,Sq,Hr,Ck)
    score block. `q_offset` is the absolute position of q[0]."""
    B, Sq, H, hd = q.shape
    Sk, G = k.shape[1], k.shape[2]
    hv = v.shape[-1]
    chunk = min(chunk, Sk)
    assert Sk % chunk == 0, (Sk, chunk)
    qf = _scaled_q(q, G)
    m = torch.full((B, G, Sq, H // G), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(B, G, Sq, H // G, hv, device=q.device)
    for k0 in range(0, Sk, chunk):
        kj = k[:, k0:k0 + chunk].float()
        vj = v[:, k0:k0 + chunk].float()
        s = torch.einsum("bqghd,bkgd->bgqhk", qf, kj)
        s = s.masked_fill(~_mask(Sq, chunk, causal, window, q_offset,
                                 q.device, k0), NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        scale = torch.exp(m - m_new)
        l = l * scale + p.sum(-1)
        acc = acc * scale[..., None] + torch.einsum("bgqhk,bkgd->bgqhd", p, vj)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3, 4).reshape(B, Sq, H, hv).to(q.dtype)


def full_attention(q, k, v, *, causal: bool, window: int = 0,
                   q_offset: int = 0):
    """Naive attention (materialises the scores); decode and oracles."""
    B, Sq, H, hd = q.shape
    Sk, G = k.shape[1], k.shape[2]
    hv = v.shape[-1]
    s = torch.einsum("bqghd,bkgd->bgqhk", _scaled_q(q, G), k.float())
    s = s.masked_fill(~_mask(Sq, Sk, causal, window, q_offset, q.device),
                      NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgqhk,bkgd->bgqhd", p, v.float())
    return out.permute(0, 2, 1, 3, 4).reshape(B, Sq, H, hv).to(q.dtype)


def gqa_block(params, x, positions, *, num_heads, num_kv_heads, head_dim,
              rope_kind, rope_theta, causal=True, window=0,
              return_kv=False, kv=None):
    """Self-attention on a full sequence -> y (B,S,D) [, (k, v)]."""
    if kv is not None:
        raise NotImplementedError(
            "cross-attention (kv=...) is not ported yet: it comes with "
            "models/encdec.py (ROADMAP.md, queue 1: other LM families)")
    if window:
        raise NotImplementedError(
            "sliding-window prefill is not ported yet: the flash kernel has "
            "no window (ROADMAP.md, queue 1: other LM families)")
    q, k, v = qkv(params, x, num_heads, num_kv_heads, head_dim)
    if rope_kind != "none":
        q = rope_lib.apply_rope(q, positions, theta=rope_theta, kind=rope_kind)
        k = rope_lib.apply_rope(k, positions, theta=rope_theta, kind=rope_kind)
    o = _prefill_attention(q, k, v, causal=causal)
    B, S = x.shape[:2]
    y = o.reshape(B, S, num_heads * head_dim) @ params["wo"]
    if return_kv:
        return y, (k, v)
    return y


def gqa_decode(params, x, cache_k, cache_v, positions, *, num_heads,
               num_kv_heads, head_dim, rope_kind, rope_theta,
               cache_index=None, window: int = 0, masked: bool = False):
    """One-token decode. x (B,1,D); cache_k/v (B,Sc,G,hd) pre-filled.

    The new token's key and value are written IN PLACE into slot
    `cache_index` of cache_k/v (default: the last slot), which saves a copy
    of the whole cache each step; the reference returns updated copies.
    With `masked=True` attention covers slots <= cache_index (incremental
    generation into a fixed-size cache; the serving path), else every slot
    (the steady-state semantics). `window` is accepted as in the reference,
    where it only names the cache a ring buffer. Keys are stored already
    rotated. Returns (y, cache_k, cache_v).
    """
    B = x.shape[0]
    q, k1, v1 = qkv(params, x, num_heads, num_kv_heads, head_dim)
    if rope_kind != "none":
        q = rope_lib.apply_rope(q, positions, theta=rope_theta, kind=rope_kind)
        k1 = rope_lib.apply_rope(k1, positions, theta=rope_theta,
                                 kind=rope_kind)
    Sc = cache_k.shape[1]
    idx = Sc - 1 if cache_index is None else int(cache_index)
    cache_k[:, idx] = k1[:, 0].to(cache_k.dtype)
    cache_v[:, idx] = v1[:, 0].to(cache_v.dtype)
    if masked:
        s = torch.einsum("bqghd,bkgd->bgqhk", _scaled_q(q, num_kv_heads),
                         cache_k.float())
        valid = torch.arange(Sc, device=x.device) <= idx
        s = s.masked_fill(~valid[None, None, None, None, :], NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bgqhk,bkgd->bgqhd", p, cache_v.float())
        o = o.permute(0, 2, 1, 3, 4).reshape(B, 1, num_heads, head_dim)
        o = o.to(q.dtype)
    else:
        o = full_attention(q, cache_k, cache_v, causal=False)
    y = o.reshape(B, 1, num_heads * head_dim) @ params["wo"]
    return y, cache_k, cache_v
