"""Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3), the port of
`repro/nn/mla.py`, in its two forms:
  - expanded (prefill): the latent kv is up-projected to per-head (k_nope,
    v), and self-attention runs through the prefill attention of
    `nn/attention.py` (the flash kernel on the card, at MLA's split head
    dims: queries and keys qk_nope + qk_rope wide, values v_head_dim; a
    sliding window, where the prefill has one, goes to the kernel too);
  - absorbed (decode): W_uk is absorbed into the query and W_uv into the
    output, so attention runs in float32 directly against the compressed
    latent cache (B, S, kv_lora + qk_rope).
`k_rope` is one rotated head, (B, S, 1, dr), with kind "rope" whatever
`cfg.rope_kind` says, broadcast to every head before attention. In train
mode the expanded form attends with the plain functions under autograd by
the reference's own rule (`mla.py:78-82`): `full_attention` when S <= 2 *
chunk, else `chunked_attention`.

On a mesh (DTensor parameters) the projections are DTensor ops: `wq_b`
and `wkv_b` split over "model" give q, k_nope and v split on heads;
`k_rope`, one head made from the replicated `wkv_a`, is broadcast and
sliced to each rank's heads, and attention runs on each rank's rows and
heads (`attention.attend`: the kernel's own `local_map` in prefill,
`local_rows` of the plain function in train mode). The absorbed decode
reads and writes the latent cache where `serve.cache_shardings` places it
(split on the sequence over "model", or on its columns where the
sequence does not divide) through `local_map`, each rank on its own block
(`_latent_attention_dtensor`): the in-place write of one slot, the scores
and the weighted sum have no DTensor rule across such a split. Only the
scores (B, H, 1, Sc) are made whole on the key axis, for the softmax over
every key; the cache never is.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import Replicate

from repro_torch import sharding
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
    other mode with the prefill kernel, `window` included."""
    B, S, _ = x.shape
    H, dn, dr, dv = (cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    q_nope, q_rope = _queries(p, cfg, x)
    q_rope = rope_lib.apply_rope(q_rope, positions, theta=cfg.rope_theta,
                                 kind="rope")
    c_kv, k_rope = _latent_kv(p, cfg, x, positions)
    kv = (c_kv @ p["wkv_b"]).reshape(B, S, H, dn + dv)
    k_rope_h = k_rope.expand(B, S, H, dr)
    if sharding.is_dtensor(kv):
        # the one rope head broadcast to every head, placed as kv's heads
        # (each rank slices its own heads, no communication)
        pl = tuple(Replicate() if t.is_partial() else t
                   for t in kv.placements)
        kv = kv.redistribute(kv.device_mesh, pl)
        k_rope_h = k_rope_h.redistribute(kv.device_mesh, pl)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([kv[..., :dn], k_rope_h], dim=-1)
    v = kv[..., dn:]
    if mode != "train":
        o = attention.attend(q, k, v, causal=True, window=window)
    elif S <= 2 * chunk:
        o = attention.attend(q, k, v, plain=lambda a, b, c:
                             attention.full_attention(a, b, c, causal=True,
                                                      window=window))
    else:
        o = attention.attend(q, k, v, plain=lambda a, b, c:
                             attention.chunked_attention(
                                 a, b, c, causal=True, window=window,
                                 chunk=chunk))
    y = o.reshape(B, S, H * dv) @ p["wo"]
    if return_cache:
        return y, torch.cat([c_kv, k_rope[:, :, 0, :]], dim=-1)
    return y


def mla_decode(p, cfg, x, cache, positions, *, cache_index=None,
               masked: bool = False):
    """Absorbed-form one-token decode against the latent cache (B, Sc,
    r_kv + dr). The new entry is written IN PLACE at slot `cache_index`
    (default: the last); with `masked=True` attention covers slots <=
    cache_index. Returns (y, cache). On a mesh each rank writes and reads
    its own block of the cache (`_latent_attention_dtensor`)."""
    B = x.shape[0]
    H, dn, dr, dv = (cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    r_kv = cfg.kv_lora_rank
    q_nope, q_rope = _queries(p, cfg, x)                      # (B,1,H,.)
    q_rope = rope_lib.apply_rope(q_rope, positions, theta=cfg.rope_theta,
                                 kind="rope")
    c_new, kr_new = _latent_kv(p, cfg, x, positions)
    new = torch.cat([c_new, kr_new[:, :, 0, :]], dim=-1)[:, 0]   # (B, R)
    Sc = cache.shape[1]
    idx = Sc - 1 if cache_index is None else int(cache_index)

    w_b = p["wkv_b"].reshape(r_kv, H, dn + dv).float()
    w_uk, w_uv = w_b[..., :dn], w_b[..., dn:]                 # (r,H,dn),(r,H,dv)
    # absorb: the latent-space query q_lat[h] = q_nope[h] @ W_uk[:, h, :]^T,
    # beside q_rope: one query (B,1,H,R) against the cache's R columns
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope.float(), w_uk)
    q_cat = torch.cat([q_lat, q_rope.float()], dim=-1)
    scale = (dn + dr) ** -0.5
    if sharding.is_dtensor(cache):
        o_lat = _latent_attention_dtensor(q_cat, new, cache, idx, masked,
                                          scale, r_kv)
    else:
        cache[:, idx] = new.to(cache.dtype)
        w = _softmax(_latent_scores(q_cat, cache, scale), idx, masked, Sc)
        o_lat = _latent_out(w, cache, r_kv)
    o = torch.einsum("bshr,rhd->bshd", o_lat, w_uv)
    y = o.reshape(B, 1, H * dv).to(x.dtype) @ p["wo"]
    return y, cache


def _latent_scores(q_cat, cache, scale):
    """q_cat (B,1,H,R) against the latent cache (B,Sc,R) -> (B,H,1,Sc)."""
    return torch.einsum("bshR,bkR->bhsk", q_cat, cache.float()) * scale


def _softmax(s, idx: int, masked: bool, Sc: int):
    if masked:
        valid = torch.arange(Sc, device=s.device) <= idx
        s = s.masked_fill(~valid[None, None, None, :], attention.NEG_INF)
    return torch.softmax(s, dim=-1)


def _latent_out(w, cache, n: int):
    """The weights (B,H,1,Sc) over the cache's first n columns (its c_kv)
    -> (B,1,H,n)."""
    return torch.einsum("bhsk,bkr->bshr", w, cache[..., :n].float())


def _latent_attention_dtensor(q_cat, new, cache, idx: int, masked: bool,
                              scale: float, r_kv: int):
    """`mla_decode`'s write, scores, softmax and weighted sum on a DTensor
    cache, each rank on its own block: on each mesh dim the cache is split
    on the batch (`Shard(0)`), on the sequence (`Shard(1)`, as
    `serve.cache_shardings` places it), on its R columns (`Shard(2)`,
    where the sequence does not divide) or whole. A rank writes the new
    entry where its block holds slot idx (its columns of it), its scores
    are a block of the keys or a `Partial` sum over its columns, and its
    weighted sum a `Partial` sum over its keys or its columns (zeros
    elsewhere). The scores (B, H, 1, Sc) are made whole on the key axis for
    the softmax, which normalises over every key; the cache is never
    gathered. -> o_lat (B,1,H,r_kv), the batch split as the cache's."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    from torch.distributed.tensor.experimental import local_map
    mesh, pl = cache.device_mesh, tuple(cache.placements)
    if any(not (p.is_replicate() or p in (Shard(0), Shard(1), Shard(2)))
           for p in pl):
        raise ValueError(f"the latent cache must be split on its batch, "
                         f"sequence or columns, or whole; got {pl}")
    _, (_, s0, r0) = compute_local_shape_and_global_offset(
        cache.shape, mesh, pl)
    rows = tuple(Shard(0) if p == Shard(0) else Replicate() for p in pl)
    Sc = cache.shape[1]

    def scores(c, q, n):
        j = idx - s0
        if 0 <= j < c.shape[1]:
            c[:, j] = n[:, r0:r0 + c.shape[2]].to(c.dtype)
        return _latent_scores(q[..., r0:r0 + c.shape[2]], c, scale)

    def out(w, c):
        n = max(0, min(r_kv - r0, c.shape[2]))
        part = _latent_out(w[..., s0:s0 + c.shape[1]], c, n)
        if n == r_kv:
            return part
        o = part.new_zeros(*part.shape[:3], r_kv)
        o[..., r0:r0 + n] = part
        return o

    by = lambda split: tuple(split[p.dim] if isinstance(p, Shard)
                             else Replicate() for p in pl)
    s = local_map(scores,
                  out_placements=(by((Shard(0), Shard(3), Partial())),),
                  in_placements=(pl, rows, rows), device_mesh=mesh)(
        cache, q_cat.redistribute(mesh, rows), new.redistribute(mesh, rows))
    w = sharding.local_rows(lambda t: _softmax(t, idx, masked, Sc), 1,
                            s.redistribute(mesh, rows))
    o = local_map(out, out_placements=(by((Shard(0), Partial(), Partial())),),
                  in_placements=(rows, pl), device_mesh=mesh)(w, cache)
    return o.redistribute(mesh, rows)
