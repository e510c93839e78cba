"""Whisper-style encoder-decoder, the port of `repro/models/encdec.py` (the
audio frontend is a stub: frames arrive as (B, T_enc, d_model) embeddings).

Encoder: bidirectional self-attention and a GELU MLP. Decoder: causal
self-attention with a KV cache, cross-attention over the encoder's output
(its K and V computed once, at prefill) and a GELU MLP. LayerNorm,
sinusoidal positions. Outside train mode every attention over a full
sequence, the encoder's, the decoder's causal self-attention and its
cross-attention, goes to `nn.attention`'s prefill attention (the flash
kernel on the card), and so does decode's cross-attention at Sq = 1; the
decoder's self-attention in decode reads its cache in `gqa_decode`. Train
mode takes the plain functions under autograd, without remat, as the
reference's scans have no checkpoint.

Parameters are a plain dict: `embed`, `enc_layers` and `dec_layers` (lists
of per-layer dicts, the port's convention for `lm`'s segments; stacked on a
layer axis in the reference), `enc_norm`, `dec_norm`, `lm_head`. Prefill
caches are `{"self": (k, v), "cross": (xk, xv)}`, each leaf stacked
(L, B, S, G, hd) as in the reference.

On a mesh (DTensor parameters, frames and tokens placed by the serve or
train shardings) the model runs as the decoder-only ones do: the token
embedding through `sharding.lookup`, the sinusoids (made whole on every
rank) placed beside the activations (`replicated_like`, `rows_like`),
attention on each rank's rows and heads (`nn/attention.py`), the cross
caches split on KV heads over "model" as `serve.cache_shardings` places
them, and the self cache padded on each rank's shard (`lm.pad_seq`:
DTensor's own pad has no plan in PyTorch 2.11).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch import sharding
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.nn import attention, layers
from repro_torch.tree import tree_map


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _inv_freq(d: int, device):
    """10000^(2i/d) for i < d/2, float32, as the reference computes it."""
    i = torch.arange(d // 2, dtype=torch.float32, device=device)
    return 10000.0 ** (2 * i / d)


def _sinusoid(seq: int, d: int, dtype, device=None):
    """(seq, d) sinusoidal positions 0..seq-1: [sin | cos] of float32
    angles, cast to `dtype`."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    ang = pos / _inv_freq(d, device)[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _sinusoid_at(positions, d: int, dtype):
    """(B, S) int positions -> (B, S, d) sinusoids in `dtype`."""
    ang = positions.float()[..., None] / _inv_freq(d, positions.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _init_gqa(gen, cfg, dt):
    return attention.init_gqa(gen, cfg.d_model, cfg.num_heads,
                              cfg.num_kv_heads, cfg.head_dim, dt)


def _init_enc_layer(gen, cfg, dt):
    dev = layers.gen_device(gen)
    return {"norm1": layers.init_layernorm(cfg.d_model, dt, dev),
            "attn": _init_gqa(gen, cfg, dt),
            "norm2": layers.init_layernorm(cfg.d_model, dt, dev),
            "mlp": layers.init_gelu_mlp(gen, cfg.d_model, cfg.d_ff, dt)}


def _init_dec_layer(gen, cfg, dt):
    dev = layers.gen_device(gen)
    return {"norm1": layers.init_layernorm(cfg.d_model, dt, dev),
            "self_attn": _init_gqa(gen, cfg, dt),
            "norm2": layers.init_layernorm(cfg.d_model, dt, dev),
            "cross_attn": _init_gqa(gen, cfg, dt),
            "norm3": layers.init_layernorm(cfg.d_model, dt, dev),
            "mlp": layers.init_gelu_mlp(gen, cfg.d_model, cfg.d_ff, dt)}


def init_encdec(gen: Optional[torch.Generator], cfg,
                device=None) -> Dict[str, Any]:
    """Random parameters drawn from `gen` on its own device, then moved to
    `device`; with `gen=None`, `meta` tensors (shapes and dtypes only), as
    `lm.init_lm`."""
    dev = torch.device("meta") if gen is None else resolve_device(device)
    dt = _dtype(cfg)
    gdev = layers.gen_device(gen)
    params = {
        "embed": layers.embed_init(gen, cfg.vocab_size, cfg.d_model, dt),
        "enc_layers": [_init_enc_layer(gen, cfg, dt)
                       for _ in range(cfg.num_encoder_layers)],
        "dec_layers": [_init_dec_layer(gen, cfg, dt)
                       for _ in range(cfg.num_layers)],
        "enc_norm": layers.init_layernorm(cfg.d_model, dt, gdev),
        "dec_norm": layers.init_layernorm(cfg.d_model, dt, gdev),
        "lm_head": layers.dense_init(gen, cfg.d_model, cfg.vocab_size, dt),
    }
    return tree_map(lambda a: a.to(dev), params)


def _kw(cfg):
    return dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.head_dim, rope_kind="none", rope_theta=10000.0)


def encode(params, cfg, frames, *, mode: str = "prefill"):
    """frames (B, T_enc, d_model) stub embeddings -> (B, T_enc, d):
    non-causal self-attention over the frames; `mode` "train" attends with
    the plain functions under autograd, any other mode with the kernel."""
    dt = _dtype(cfg)
    B, T, _ = frames.shape
    x = frames.to(dt) + sharding.replicated_like(
        _sinusoid(T, cfg.d_model, dt, frames.device)[None], frames)
    for lp in params["enc_layers"]:
        h = layers.layernorm(lp["norm1"], x, cfg.norm_eps)
        x = x + attention.gqa_block(lp["attn"], h, None, causal=False,
                                    mode=mode, **_kw(cfg))
        h = layers.layernorm(lp["norm2"], x, cfg.norm_eps)
        x = x + layers.gelu_mlp(lp["mlp"], h)
    return layers.layernorm(params["enc_norm"], x, cfg.norm_eps)


def _cross_kv(lp, cfg, enc_out):
    """Cross-attention K and V (B, T, G, hd) of one decoder layer from the
    encoder's output."""
    B, T, _ = enc_out.shape
    k = (enc_out @ lp["cross_attn"]["wk"]).reshape(B, T, cfg.num_kv_heads,
                                                  cfg.head_dim)
    v = (enc_out @ lp["cross_attn"]["wv"]).reshape(B, T, cfg.num_kv_heads,
                                                  cfg.head_dim)
    return k, v


def decode_forward(params, cfg, tokens, enc_out, *, mode: str = "train",
                   self_cache=None, cross_kv=None, positions=None,
                   cache_index=None, masked: bool = False):
    """The decoder over target tokens -> dict(features, logits, caches,
    aux).

    train / prefill: tokens (B, S) over `enc_out`; prefill also returns the
    caches {"self": (k, v), "cross": (xk, xv)}, each (L, B, S, G, hd).
    decode: tokens (B, 1), `self_cache` a stacked (k, v) pair and
    `cross_kv` the prefill's cross caches; the new token's K and V are
    written IN PLACE into slot `cache_index` of the self cache (default:
    the last slot, every slot attended, the reference's steady state; with
    `masked=True` only slots <= cache_index, the serving path), and the
    same caches are returned. The position is `cache_index`, or the last
    slot's without one.
    """
    dt = _dtype(cfg)
    B, S = tokens.shape
    kw = _kw(cfg)
    x = sharding.lookup(params["embed"], tokens)
    if positions is None:
        offset = 0
        if mode == "decode":
            offset = (self_cache[0].shape[2] - 1 if cache_index is None
                      else int(cache_index))
        positions = (offset + torch.arange(S, device=x.device))[None]
        positions = positions.expand(B, S)
    x = x + sharding.rows_like(_sinusoid_at(positions, cfg.d_model, dt), x)

    caches = None
    if mode == "decode":
        ck, cv = self_cache
        xk, xv = cross_kv
        for i, lp in enumerate(params["dec_layers"]):
            h = layers.layernorm(lp["norm1"], x, cfg.norm_eps)
            y, _, _ = attention.gqa_decode(lp["self_attn"], h, ck[i], cv[i],
                                           positions, cache_index=cache_index,
                                           masked=masked, **kw)
            x = x + y
            h = layers.layernorm(lp["norm2"], x, cfg.norm_eps)
            x = x + attention.gqa_block(lp["cross_attn"], h, positions,
                                        causal=False, kv=(xk[i], xv[i]),
                                        **kw)
            h = layers.layernorm(lp["norm3"], x, cfg.norm_eps)
            x = x + layers.gelu_mlp(lp["mlp"], h)
        caches = {"self": self_cache, "cross": cross_kv}
    else:
        prefill = mode == "prefill"
        self_kv, cross = [], []
        for lp in params["dec_layers"]:
            h = layers.layernorm(lp["norm1"], x, cfg.norm_eps)
            y = attention.gqa_block(lp["self_attn"], h, positions,
                                    causal=True, return_kv=prefill,
                                    mode=mode, **kw)
            if prefill:
                y, kv = y
                self_kv.append(kv)
            x = x + y
            xkv = _cross_kv(lp, cfg, enc_out)
            h = layers.layernorm(lp["norm2"], x, cfg.norm_eps)
            x = x + attention.gqa_block(lp["cross_attn"], h, positions,
                                        causal=False, kv=xkv, mode=mode,
                                        **kw)
            h = layers.layernorm(lp["norm3"], x, cfg.norm_eps)
            x = x + layers.gelu_mlp(lp["mlp"], h)
            if prefill:
                cross.append(xkv)
        if prefill:
            stack = lambda *ls: torch.stack(ls)
            caches = {"self": tree_map(stack, *self_kv),
                      "cross": tree_map(stack, *cross)}

    features = layers.layernorm(params["dec_norm"], x, cfg.norm_eps)
    return {"features": features, "logits": features @ params["lm_head"],
            "caches": caches, "aux": 0.0}


def init_self_cache(cfg, batch_size: int, ctx_len: int, device=None):
    """Zero self-attention caches (k, v), each (L, B, ctx_len, G, hd)."""
    dev = resolve_device(device)
    z = lambda hd: torch.zeros(cfg.num_layers, batch_size, ctx_len,
                               cfg.num_kv_heads, hd, dtype=_dtype(cfg),
                               device=dev)
    return (z(cfg.head_dim), z(cfg.v_head_dim))


def pad_cache_for_decode(caches, extra: int = 1):
    """Append `extra` empty slots (new tensors) to the self cache's sequence
    axis; the cross caches are read-only and passed on as they are.
    Padding a prefill(S-1) cache by one makes decode an exact append, as
    `lm.pad_cache_for_decode`; serving grows it by its generation budget."""
    pad = lambda a: lm.pad_seq(a, 2, extra)
    return {"self": tree_map(pad, caches["self"]), "cross": caches["cross"]}
