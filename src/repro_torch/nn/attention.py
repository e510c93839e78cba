"""GQA attention, the port of `repro/nn/attention.py`: prefill through the
hand-written flash kernel, training and decode as plain PyTorch ops.

`gqa_block` takes the mode. Outside train mode its attention goes to
`kernels.ops.flash_attention`: the CUDA kernel for tensors on the card, its
plain version for tensors on the CPU. That holds for self-attention
(causal, `q_offset = 0`) and for cross-attention (`kv=(k, v)` given, no
rope, `causal=False`, Sq != Sk: Whisper's decoder over the encoder's
frames, in prefill and, at Sq = 1, in decode), which are the functions the
reference computes with `full_attention` or `chunked_attention`
(`attention.py:134-137`). Sliding-window prefill (`window` W > 0, the
reference's mask q_pos - k_pos < W) goes to the same kernel, which takes
the window and skips the key tiles left of it. In train mode it calls
those plain functions by the reference's own rule (`full_attention` when
`Sk <= 2 * chunk` or `Sk % chunk != 0`, else `chunked_attention`), under
autograd, as the reference trains: the choice is fixed by the mode, never
by whether a kernel builds, and nothing is routed quietly to a plain path
on the card. `gqa_decode` uses `full_attention` against the
self-attention cache.

Layouts: x (B, S, D); q (B, S, H, hd); k/v (B, S, G, hd) with G = KV heads.

On a mesh (DTensor parameters, `sharding.place`) the projections
propagate as DTensor ops: `wq`/`wk`/`wv` split over "model" leave q, k and
v split on heads, `wo`'s rows give a `Partial` sum that the residual add
reduces. Attention itself runs on each rank's batch rows and whole heads
(`_heads`): in prefill through the kernel's own `local_map`
(`ops.flash_attention`), in train mode and decode through `local_map` of
the plain functions here (`attend`, which `nn/mla.py` shares), the decode
writing its rank's cache shard in place.
"""
from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch import sharding
from repro_torch.kernels import ops
from repro_torch.nn import layers, rope as rope_lib

NEG_INF = -1e30

# What gqa_block's self-attention calls; `prefill_attention` swaps it.
_prefill_attention = ops.flash_attention


@contextlib.contextmanager
def prefill_attention(fn):
    """Run gqa_block's self-attention through `fn(q, k, v, causal=...)`
    (and `window=W` where the prefill has a window) instead of the kernel
    inside the `with` block (for a check that holds the kernel path against
    its plain version through a whole model)."""
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


def _heads(q, k, v):
    """DTensor q (B, S, H, hd) and k, v (B, S, G, .) placed alike, as
    attention on each rank's shard needs them (the placements
    `ops.flash_attention` declares): on each mesh dim `Shard(0)` where all
    three split the batch, `Shard(2)` where all three split the heads and
    the dim divides both H and G (a rank's query heads then read its own KV
    heads), else `Replicate()`: heads whose split does not divide, or a
    split of head_dim, are gathered whole, since a split there would
    compute another softmax."""
    mesh = q.device_mesh
    H, G = q.shape[2], k.shape[2]
    want = []
    for i in range(mesh.ndim):
        ps = (q.placements[i], k.placements[i], v.placements[i])
        if all(p == Shard(0) for p in ps):
            want.append(Shard(0))
        elif (all(p == Shard(2) for p in ps) and H % mesh.size(i) == 0
              and G % mesh.size(i) == 0):
            want.append(Shard(2))
        else:
            want.append(Replicate())
    return tuple(t if tuple(t.placements) == tuple(want)
                 else t.redistribute(mesh, want) for t in (q, k, v))


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


def attend(q, k, v, *, causal: bool = True, window: int = 0, plain=None):
    """Attention over a full sequence: the prefill kernel (through
    `_prefill_attention`, with the sliding window `window` where it is not
    0), or `plain(q, k, v)` (train mode's plain
    function, under autograd). On a mesh q, k and v are placed alike first
    (`_heads`), and either runs on each rank's batch rows and whole heads:
    the kernel through its own `local_map`, `plain` through
    `sharding.local_rows`."""
    if sharding.is_dtensor(q):
        q, k, v = _heads(q, k, v)
    if plain is None:
        kw = {"window": window} if window else {}
        return _prefill_attention(q, k, v, causal=causal, **kw)
    return sharding.local_rows(plain, 1, q, k, v, split_dims=(0, 2))


def gqa_block(params, x, positions, *, num_heads, num_kv_heads, head_dim,
              rope_kind, rope_theta, causal=True, window=0,
              return_kv=False, kv=None, mode: str = "prefill",
              chunk: int = 512):
    """Self- or cross-attention on a full sequence -> y (B,S,D) [, (k, v)].
    `kv`: the (k, v) (B, Sk, G, hd) to attend to (cross-attention; no rope
    is applied, as in the reference), else the sequence's own. `mode`
    "train" computes it with the plain functions (see the module's
    docstring), any other mode with the prefill kernel, `window` included."""
    if kv is None:
        q, k, v = qkv(params, x, num_heads, num_kv_heads, head_dim)
        if rope_kind != "none":
            q = rope_lib.apply_rope(q, positions, theta=rope_theta,
                                    kind=rope_kind)
            k = rope_lib.apply_rope(k, positions, theta=rope_theta,
                                    kind=rope_kind)
    else:
        B, S = x.shape[:2]
        q = (x @ params["wq"]).reshape(B, S, num_heads, head_dim)
        k, v = kv
    if mode != "train":
        o = attend(q, k, v, causal=causal, window=window)
    elif k.shape[1] <= 2 * chunk or k.shape[1] % chunk != 0:
        o = attend(q, k, v, plain=lambda a, b, c: full_attention(
            a, b, c, causal=causal, window=window))
    else:
        o = attend(q, k, v, plain=lambda a, b, c: chunked_attention(
            a, b, c, causal=causal, window=window, chunk=chunk))
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
    if sharding.is_dtensor(q):
        # each rank writes its cache shard in place: q, k1 and v1 take the
        # cache's placements, which must be those attention on a rank's
        # shard takes (`_heads`)
        mesh, pl = cache_k.device_mesh, tuple(cache_k.placements)
        G = cache_k.shape[2]
        for i, p in enumerate(pl):
            w = mesh.size(i)
            ok = (w == 1 or p.is_replicate() or p == Shard(0)
                  or (p == Shard(2) and num_heads % w == 0 and G % w == 0))
            if not ok or tuple(cache_v.placements) != pl:
                raise ValueError(
                    f"decode on a mesh writes each rank's cache shard in "
                    f"place: the caches must be split on batch (Shard(0)) or "
                    f"whole KV heads (Shard(2)), alike; got {pl} and "
                    f"{tuple(cache_v.placements)}")
        q, k1, v1 = (t.redistribute(mesh, pl) for t in (q, k1, v1))
        fn = lambda *a: _decode_attend(*a, idx=idx, masked=masked)
        o = sharding.local_rows(fn, 1, q, k1, v1, cache_k, cache_v,
                                split_dims=range(4))
    else:
        o = _decode_attend(q, k1, v1, cache_k, cache_v, idx=idx,
                           masked=masked)
    y = o.reshape(B, 1, num_heads * head_dim) @ params["wo"]
    return y, cache_k, cache_v


def _decode_attend(q, k1, v1, cache_k, cache_v, *, idx: int, masked: bool):
    """Write the new token's k1, v1 into slot `idx` of the caches in place
    and attend q to them -> o (B, 1, H, hd)."""
    B, _, num_heads, head_dim = q.shape
    num_kv_heads, Sc = cache_k.shape[2], cache_k.shape[1]
    cache_k[:, idx] = k1[:, 0].to(cache_k.dtype)
    cache_v[:, idx] = v1[:, 0].to(cache_v.dtype)
    if masked:
        s = torch.einsum("bqghd,bkgd->bgqhk", _scaled_q(q, num_kv_heads),
                         cache_k.float())
        valid = torch.arange(Sc, device=q.device) <= idx
        s = s.masked_fill(~valid[None, None, None, None, :], NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bgqhk,bkgd->bgqhd", p, cache_v.float())
        o = o.permute(0, 2, 1, 3, 4).reshape(B, 1, num_heads, head_dim)
        return o.to(q.dtype)
    return full_attention(q, cache_k, cache_v, causal=False)
