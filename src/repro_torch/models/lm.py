"""Decoder-only LM spine, the port of `repro/models/lm.py` for GQA models
with dense MLPs (TinyLlama and its reduced variants).

Parameters are a plain dict: `embed` (V, D), `segments` (one list of
per-layer dicts for each segment of `blocks.segments_of(cfg)`),
`final_norm` and `lm_head` (D, V), absent when the embeddings are tied.
`forward` covers train (features and logits) and prefill (also the caches);
`decode_step` is the one-token serve path. Features are the post-final-norm
last hidden states, the d'-dimensional representations the paper shares.
Caches are `{"segments": [(K, V), ...], "shared": []}` with K and V of
shape (L, B, S, G, hd), the reference's layout.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models import blocks
from repro_torch.nn import layers, rope as rope_lib

_LATER = "is not ported yet (ROADMAP.md, queue 1: other LM families)"


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_supported(cfg) -> None:
    if cfg.shared_attn_period:
        raise NotImplementedError(f"the shared attention block {_LATER}")
    if cfg.is_encoder_decoder:
        raise NotImplementedError(f"encoder-decoder models {_LATER}")


def init_lm(gen: torch.Generator, cfg, device=None) -> Dict[str, Any]:
    """Random parameters drawn from `gen` on its own device (a CUDA generator
    makes full-width weights in well under a second), then moved to
    `device`."""
    _check_supported(cfg)
    dev = resolve_device(device)
    dt = _dtype(cfg)
    params: Dict[str, Any] = {}
    if cfg.input_kind == "tokens":
        params["embed"] = layers.embed_init(gen, cfg.vocab_size, cfg.d_model, dt)
    params["segments"] = blocks.init_segments(gen, cfg, dt)
    params["final_norm"] = layers.init_norm(cfg.norm_kind, cfg.d_model, dt,
                                            gen.device)
    if not cfg.tie_embeddings or cfg.input_kind != "tokens":
        params["lm_head"] = layers.dense_init(gen, cfg.d_model,
                                              cfg.vocab_size, dt)
    return _to_device(params, dev)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


def _embed(params, cfg, batch):
    if cfg.input_kind == "tokens":
        return params["embed"][batch["tokens"].long()]
    return batch["embeddings"].to(_dtype(cfg))


def _head(params, cfg, features):
    w = params.get("lm_head")
    if w is None:                                   # tied
        w = params["embed"].T
    return features @ w


def _positions(cfg, batch, B, S, device, offset=0):
    pos = batch.get("positions")
    if pos is None:
        pos = rope_lib.default_positions(B, S, cfg.rope_kind, offset=offset,
                                         device=device)
    return pos


def forward(params, cfg, batch, *, mode: str = "train", window: int = 0):
    """-> dict(features, logits, aux, caches); caches only for prefill; aux
    is 0.0 (no MoE layers are ported)."""
    _check_supported(cfg)
    x = _embed(params, cfg, batch)
    B, S = x.shape[:2]
    positions = _positions(cfg, batch, B, S, x.device)
    aux_total = 0.0
    caches: Dict[str, Any] = {"segments": [], "shared": []}
    for seg_params, (kind, _) in zip(params["segments"],
                                     blocks.segments_of(cfg)):
        x, aux, cache = blocks.run_segment(seg_params, cfg, kind, x,
                                           positions, window=window, mode=mode)
        aux_total = aux_total + aux
        caches["segments"].append(cache)
    features = layers.apply_norm(cfg.norm_kind, params["final_norm"], x,
                                 cfg.norm_eps)
    return {"features": features, "logits": _head(params, cfg, features),
            "aux": aux_total, "caches": caches if mode == "prefill" else None}


def decode_step(params, cfg, batch, caches, *, window: int = 0,
                cache_index=None, masked: bool = False):
    """One-token decode. batch: tokens (B, 1) (or embeddings (B, 1, d)).

    caches: from `forward(mode="prefill")` (grown or padded) or
    `init_cache`; the new token's keys and values are written into them IN
    PLACE and the same caches are returned. Default (steady-state)
    semantics: the token overwrites the LAST slot and every slot is valid.
    Serving semantics: `cache_index` (an int, the slot to write) and
    `masked=True` (attend only to slots <= cache_index).
    """
    _check_supported(cfg)
    x = _embed(params, cfg, batch)
    B = x.shape[0]
    positions = batch.get("positions")
    if positions is None:
        offset = (_cache_len(cfg, caches) - 1 if cache_index is None
                  else int(cache_index))
        positions = rope_lib.default_positions(B, 1, cfg.rope_kind,
                                               offset=offset, device=x.device)
    new_caches: Dict[str, Any] = {"segments": [], "shared": []}
    for seg_params, (kind, _), cache in zip(
            params["segments"], blocks.segments_of(cfg), caches["segments"]):
        x, _, nc = blocks.run_segment(
            seg_params, cfg, kind, x, positions, window=window, mode="decode",
            cache=cache, cache_index=cache_index, masked=masked)
        new_caches["segments"].append(nc)
    features = layers.apply_norm(cfg.norm_kind, params["final_norm"], x,
                                 cfg.norm_eps)
    return {"features": features, "logits": _head(params, cfg, features),
            "caches": new_caches}


def _cache_len(cfg, caches) -> int:
    for seg, (kind, _) in zip(caches["segments"], blocks.segments_of(cfg)):
        if kind == "attn":
            return seg[0].shape[2]           # (L,B,S,G,hd)
    return 1


def init_cache(cfg, batch_size: int, ctx_len: int, *, window: int = 0,
               device=None):
    """Zero caches shaped for decode at context length ctx_len."""
    _check_supported(cfg)
    dev = resolve_device(device)
    S = min(ctx_len, window) if window else ctx_len
    caches: Dict[str, Any] = {"segments": [], "shared": []}
    for kind, n in blocks.segments_of(cfg):
        blocks.check_supported(cfg, kind)
        shape = (n, batch_size, S, cfg.num_kv_heads, cfg.head_dim)
        caches["segments"].append(
            (torch.zeros(shape, dtype=_dtype(cfg), device=dev),
             torch.zeros(shape[:-1] + (cfg.v_head_dim,), dtype=_dtype(cfg),
                         device=dev)))
    return caches


def pad_cache_for_decode(cfg, caches, extra: int = 1):
    """Append `extra` empty slots (new tensors) to every attention cache's
    sequence axis.

    decode_step writes the new token at the LAST cache slot; padding a
    prefill(S-1)-cache to length S makes the decode an exact append:
    decode(x_S | prefill(x_0..x_{S-1})) equals forward(x_0..x_S) at the last
    position. Serving grows the cache by its whole generation budget.
    """
    out = {"segments": [], "shared": []}
    for (kind, _), cache in zip(blocks.segments_of(cfg), caches["segments"]):
        out["segments"].append(
            tuple(F.pad(a, (0, 0, 0, 0, 0, extra)) for a in cache)
            if kind == "attn" else cache)
    return out
