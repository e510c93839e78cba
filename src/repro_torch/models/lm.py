"""Decoder-only LM spine, the port of `repro/models/lm.py`, shared by every
decoder-only architecture: GQA or MLA attention with a dense MLP or MoE,
mamba with zamba2's shared attention block, and the xLSTM kinds.

Parameters are a plain dict: `embed` (V, D) for token models, `segments`
(one list of per-layer dicts for each segment of `blocks.segments_of(cfg)`),
`final_norm`, `lm_head` (D, V), absent when the embeddings are tied, and
`shared`, the one attention block that zamba2 applies after every
`shared_attn_period` layers. `forward` covers train (features and logits
with their autograd graph, each layer rematerialised by
`blocks.REMAT_POLICY`) and prefill (also the caches); `decode_step` is the
one-token serve path. Features are the post-final-norm last hidden
states, the d'-dimensional representations the paper shares.
Caches are `{"segments": [...], "shared": [...]}` in the reference's
layout: one stacked cache a segment (`blocks`), and one unstacked
attention cache for each application of the shared block.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from repro_torch import sharding
from repro_torch.device import resolve_device
from repro_torch.models import blocks
from repro_torch.nn import layers, rope as rope_lib
from repro_torch.tree import tree_map


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_supported(cfg) -> None:
    if cfg.is_encoder_decoder:
        raise ValueError(
            f"{cfg.name} is an encoder-decoder: models.lm holds the "
            f"decoder-only models, models.encdec this one")


def shared_points(cfg) -> List[int]:
    """Cumulative-layer counts after which the shared attn block runs."""
    if not cfg.shared_attn_period:
        return []
    k = cfg.shared_attn_period
    return list(range(k, cfg.num_layers + 1, k))


def init_lm(gen: Optional[torch.Generator], cfg,
            device=None) -> Dict[str, Any]:
    """Random parameters drawn from `gen` on its own device (a CUDA generator
    makes full-width weights in well under a second), then moved to
    `device`. With `gen=None` the parameters are `meta` tensors (shapes and
    dtypes only, whatever `device` says)."""
    _check_supported(cfg)
    dev = torch.device("meta") if gen is None else resolve_device(device)
    dt = _dtype(cfg)
    params: Dict[str, Any] = {}
    if cfg.input_kind == "tokens":
        params["embed"] = layers.embed_init(gen, cfg.vocab_size, cfg.d_model, dt)
    params["segments"] = blocks.init_segments(gen, cfg, dt)
    params["final_norm"] = layers.init_norm(cfg.norm_kind, cfg.d_model, dt,
                                            layers.gen_device(gen))
    if not cfg.tie_embeddings or cfg.input_kind != "tokens":
        params["lm_head"] = layers.dense_init(gen, cfg.d_model,
                                              cfg.vocab_size, dt)
    if cfg.shared_attn_period:
        params["shared"] = blocks.init_block(gen, cfg, "attn", dt)
    return tree_map(lambda a: a.to(dev), params)


def _embed(params, cfg, batch):
    if cfg.input_kind == "tokens":
        return sharding.lookup(params["embed"], batch["tokens"])
    return batch["embeddings"].to(_dtype(cfg))


def _head(params, cfg, features):
    w = params.get("lm_head")
    if w is None:                                   # tied
        w = params["embed"].T
    return features @ w


def _positions(cfg, batch, x, offset=0):
    """The batch's positions, or the default ones from `offset`, placed as
    x's batch rows when x is a DTensor."""
    pos = batch.get("positions")
    if pos is None:
        B, S = x.shape[:2]
        pos = sharding.rows_like(
            rope_lib.default_positions(B, S, cfg.rope_kind, offset=offset,
                                       device=x.device), x)
    return pos


def forward(params, cfg, batch, *, mode: str = "train", window: int = 0):
    """-> dict(features, logits, aux, caches); caches only for prefill; aux
    sums the MoE balance losses (0.0 without MoE layers)."""
    _check_supported(cfg)
    x = _embed(params, cfg, batch)
    positions = _positions(cfg, batch, x)
    points = shared_points(cfg)
    aux_total = 0.0
    caches: Dict[str, Any] = {"segments": [], "shared": []}
    count = 0
    for seg_params, (kind, n) in zip(params["segments"],
                                     blocks.segments_of(cfg)):
        x, aux, cache = blocks.run_segment(seg_params, cfg, kind, x,
                                           positions, window=window, mode=mode)
        aux_total = aux_total + aux
        caches["segments"].append(cache)
        count += n
        if count in points:
            x, aux2, sc = blocks.apply_block(params["shared"], cfg, "attn", x,
                                             positions, window=window,
                                             mode=mode)
            aux_total = aux_total + aux2
            caches["shared"].append(sc)
    features = layers.apply_norm(cfg.norm_kind, params["final_norm"], x,
                                 cfg.norm_eps)
    return {"features": features, "logits": _head(params, cfg, features),
            "aux": aux_total, "caches": caches if mode == "prefill" else None}


def decode_step(params, cfg, batch, caches, *, window: int = 0,
                cache_index=None, masked: bool = False):
    """One-token decode. batch: tokens (B, 1) (or embeddings (B, 1, d), with
    positions (B, 1, 3) for M-RoPE).

    caches: from `forward(mode="prefill")` (grown or padded) or
    `init_cache`; attention caches get the new token's entries IN PLACE,
    recurrent states are overwritten with the new ones, and the same caches
    are returned. Default (steady-state) semantics: the token overwrites
    the LAST slot and every slot is valid. Serving semantics: `cache_index`
    (an int, the slot to write) and `masked=True` (attend only to slots <=
    cache_index).
    """
    _check_supported(cfg)
    x = _embed(params, cfg, batch)
    offset = (_cache_len(cfg, caches) - 1 if cache_index is None
              else int(cache_index))
    positions = _positions(cfg, batch, x, offset)
    points = shared_points(cfg)
    new_caches: Dict[str, Any] = {"segments": [], "shared": []}
    count = 0
    for seg_params, (kind, n), cache in zip(
            params["segments"], blocks.segments_of(cfg), caches["segments"]):
        x, _, nc = blocks.run_segment(
            seg_params, cfg, kind, x, positions, window=window, mode="decode",
            cache=cache, cache_index=cache_index, masked=masked)
        new_caches["segments"].append(nc)
        count += n
        if count in points:
            x, _, sc = blocks.apply_block(
                params["shared"], cfg, "attn", x, positions, window=window,
                mode="decode", cache=caches["shared"][len(new_caches["shared"])],
                cache_index=cache_index, masked=masked)
            new_caches["shared"].append(sc)
    features = layers.apply_norm(cfg.norm_kind, params["final_norm"], x,
                                 cfg.norm_eps)
    return {"features": features, "logits": _head(params, cfg, features),
            "caches": new_caches}


def _cache_len(cfg, caches) -> int:
    for seg, (kind, _) in zip(caches["segments"], blocks.segments_of(cfg)):
        if kind == "attn":
            return seg.shape[2] if cfg.is_mla else seg[0].shape[2]
    if caches["shared"]:
        sc = caches["shared"][0]
        return sc.shape[1] if cfg.is_mla else sc[0].shape[1]
    return 1


def init_cache(cfg, batch_size: int, ctx_len: int, *, window: int = 0,
               device=None):
    """Zero caches shaped for decode at context length ctx_len (the
    sLSTM's m at -30.0, as its scan starts)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    dt = _dtype(cfg)
    S = min(ctx_len, window) if window else ctx_len

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def attn_cache(n):
        if cfg.is_mla:
            return zeros(n, batch_size, S, cfg.kv_lora_rank + cfg.qk_rope_dim)
        return (zeros(n, batch_size, S, cfg.num_kv_heads, cfg.head_dim),
                zeros(n, batch_size, S, cfg.num_kv_heads, cfg.v_head_dim))

    f32 = torch.float32
    caches: Dict[str, Any] = {"segments": [], "shared": []}
    for kind, n in blocks.segments_of(cfg):
        if kind == "attn":
            caches["segments"].append(attn_cache(n))
        elif kind == "mamba":
            C = cfg.d_inner + 2 * cfg.ssm_state
            caches["segments"].append(
                (zeros(n, batch_size, cfg.ssm_conv - 1, C),
                 zeros(n, batch_size, cfg.mamba_heads, cfg.mamba_head_dim,
                       cfg.ssm_state, dtype=f32)))
        elif kind == "mlstm":
            di = 2 * cfg.d_model
            P = di // cfg.num_heads
            caches["segments"].append(
                (zeros(n, batch_size, cfg.ssm_conv - 1, di),
                 zeros(n, batch_size, cfg.num_heads, P + 1, P, dtype=f32)))
        elif kind == "slstm":
            z = zeros(n, batch_size, cfg.d_model, dtype=f32)
            caches["segments"].append(
                (z, z.clone(), torch.full_like(z, -30.0), z.clone()))
        else:
            raise ValueError(kind)
    for _ in shared_points(cfg):           # the shared block is unstacked
        caches["shared"].append(tree_map(lambda a: a[0], attn_cache(1)))
    return caches


def pad_seq(a, axis: int, extra: int):
    """a with `extra` zero slots appended on `axis` (a new tensor). A
    DTensor is padded on each rank's shard through `local_map` (DTensor's
    own pad fails to plan its redistribution in PyTorch 2.11), gathered
    whole on `axis` first where that axis is split."""
    axis %= a.dim()
    pad = lambda t: F.pad(t, [0, 0] * (t.dim() - 1 - axis) + [0, extra])
    return sharding.local_rows(pad, 1, a, split_dims=[
        d for d in range(a.dim()) if d != axis])


def pad_cache_for_decode(cfg, caches, extra: int = 1):
    """Append `extra` empty slots (new tensors) to every attention cache's
    sequence axis: axis 2 of a segment's stacked cache, axis 1 of a shared
    block's. Recurrent states need no padding and are passed on as they
    are.

    decode_step writes the new token at the LAST cache slot; padding a
    prefill(S-1)-cache to length S makes the decode an exact append:
    decode(x_S | prefill(x_0..x_{S-1})) equals forward(x_0..x_S) at the last
    position. Serving grows the cache by its whole generation budget.
    """
    out = {"segments": [], "shared": []}
    for (kind, _), cache in zip(blocks.segments_of(cfg), caches["segments"]):
        out["segments"].append(
            tree_map(lambda a: pad_seq(a, 2, extra), cache)
            if kind == "attn" else cache)
    for cache in caches["shared"]:
        out["shared"].append(tree_map(lambda a: pad_seq(a, 1, extra), cache))
    return out
