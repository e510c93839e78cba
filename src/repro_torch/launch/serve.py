"""Serving steps, the port of `repro/launch/serve.py`'s single-device half:
prefill (build the caches and the first logits) and decode (one token
against the cache), and the abstract inputs of each step as `meta` tensors
(shapes and dtypes only). CoRS is a training-time technique; serving is
the plain model, so these steps carry no prototype traffic. An
encoder-decoder (Whisper) prefills from tokens and audio frames, encoding
the frames once, and decodes against its self and cross caches.

Shardings, as the reference's (`params_shardings`, `cache_shardings`,
`batch_shardings`), give a spec tree (`sharding.py`: a tuple an array,
one entry a dim) over a mesh's axis names and sizes; `sharding.place` puts
a tree on a `DeviceMesh` by them, and the steps run unchanged on the
placed parameters, caches and batch. Cache sharding: batch over "data"
when divisible; otherwise (long_500k, B=1) the cache *sequence* axis is
sharded over "data". KV heads shard over "model" when divisible, else
head_dim, else replicated (sharding.head_axis_plan).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import sharding
from repro_torch.models import encdec, lm
from repro_torch.tree import tree_map
from repro_torch.types import ModelConfig, ShapeConfig

META = torch.device("meta")


def decode_window(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Effective attention cache length for this shape (the sliding-window
    variant for 500k-token contexts on attention archs)."""
    if shape.seq_len >= 1 << 19 and cfg.long_context_mode == "swa":
        return cfg.swa_window
    return 0


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        if cfg.is_encoder_decoder:
            enc = encdec.encode(params, cfg, batch["frames"])
            out = encdec.decode_forward(params, cfg, batch["tokens"], enc,
                                        mode="prefill")
        else:
            out = lm.forward(params, cfg, batch, mode="prefill")
        return {"logits": out["logits"][:, -1:, :], "caches": out["caches"]}
    return prefill_step


def make_decode_step(cfg: ModelConfig, *, window: int = 0):
    def decode_step(params, batch, caches, cache_index=None,
                    masked: bool = False):
        if cfg.is_encoder_decoder:
            out = encdec.decode_forward(
                params, cfg, batch["tokens"], None, mode="decode",
                self_cache=caches["self"], cross_kv=caches["cross"],
                cache_index=cache_index, masked=masked)
        else:
            out = lm.decode_step(params, cfg, batch, caches, window=window,
                                 cache_index=cache_index, masked=masked)
        return {"logits": out["logits"], "caches": out["caches"]}
    return decode_step


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------
def params_shapes(cfg: ModelConfig):
    """The parameters of `lm.init_lm` (`encdec.init_encdec` for an
    encoder-decoder) as `meta` tensors."""
    if cfg.is_encoder_decoder:
        return encdec.init_encdec(None, cfg)
    return lm.init_lm(None, cfg)


def serve_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """A step's batch as `meta` tensors: tokens (B, S) int32, or embeddings
    (B, S, d) with M-RoPE positions (B, S, 3) int32 where the rope is
    M-RoPE; S is 1 but for a prefill shape. An encoder-decoder's prefill
    also takes its frames (B, encoder_seq, d) in the model's dtype."""
    B = shape.global_batch
    S = shape.seq_len if shape.mode == "prefill" else 1
    dt = getattr(torch, cfg.dtype)
    batch: Dict[str, Any] = {}
    if cfg.input_kind == "tokens" or cfg.is_encoder_decoder:
        batch["tokens"] = torch.empty(B, S, dtype=torch.int32, device=META)
    else:
        batch["embeddings"] = torch.empty(B, S, cfg.d_model, dtype=dt,
                                          device=META)
        if cfg.rope_kind == "mrope":
            batch["positions"] = torch.empty(B, S, 3, dtype=torch.int32,
                                             device=META)
    if cfg.is_encoder_decoder and shape.mode == "prefill":
        batch["frames"] = torch.empty(B, cfg.encoder_seq, cfg.d_model,
                                      dtype=dt, device=META)
    return batch


def cache_shapes(cfg: ModelConfig, shape: ShapeConfig):
    """`lm.init_cache` at this shape (its window included) as `meta`
    tensors; an encoder-decoder's self cache (L, B, seq_len, G, hd) and its
    cross caches (L, B, encoder_seq, G, hd)."""
    B = shape.global_batch
    if cfg.is_encoder_decoder:
        z = lambda hd: torch.empty(cfg.num_layers, B, cfg.encoder_seq,
                                   cfg.num_kv_heads, hd,
                                   dtype=getattr(torch, cfg.dtype),
                                   device=META)
        return {"self": encdec.init_self_cache(cfg, B, shape.seq_len, META),
                "cross": (z(cfg.head_dim), z(cfg.v_head_dim))}
    return lm.init_cache(cfg, B, shape.seq_len,
                         window=decode_window(cfg, shape), device=META)


# ---------------------------------------------------------------------------
# shardings
# ---------------------------------------------------------------------------
def params_shardings(pshapes, cfg: ModelConfig, mesh):
    """Serving: no FSDP (weights stay resident); TP over the model axis
    only."""
    return sharding.tree_param_specs(pshapes, mesh, fsdp=False)


def _cache_leaf_spec(shape, cfg: ModelConfig, mesh, batch: int,
                     shard_seq: bool) -> tuple:
    """Heuristic spec for a stacked cache leaf (leading layer axis)."""
    dp = sharding.dp_axes(mesh)
    tp = sharding.axis_size(mesh, "model")
    nd = len(shape)
    spec = [None] * nd
    # find the batch dim (first dim == batch after the layer axis)
    bdim = 1 if nd >= 2 and shape[1] == batch else None
    if bdim is not None and not shard_seq:
        if batch % sharding.dp_size(mesh) == 0:
            spec[bdim] = dp if len(dp) > 1 else dp[0]
    if shard_seq and nd >= 3:
        # long-context: shard the sequence axis (dim 2) over data
        if shape[2] % sharding.dp_size(mesh) == 0:
            spec[2] = dp if len(dp) > 1 else dp[0]
    # shard a trailing "heads-like" or feature dim over model
    for d in range(nd - 2, 1, -1):
        if spec[d] is None and shape[d] % tp == 0 and shape[d] >= tp:
            spec[d] = "model"
            break
    else:
        if nd >= 2 and spec[-1] is None and shape[-1] % tp == 0 \
                and shape[-1] >= tp:
            spec[-1] = "model"
    return tuple(spec)


def cache_shardings(cshapes, cfg: ModelConfig, mesh, shape: ShapeConfig):
    shard_seq = shape.global_batch < sharding.dp_size(mesh)
    return tree_map(
        lambda l: _cache_leaf_spec(tuple(l.shape), cfg, mesh,
                                   shape.global_batch, shard_seq), cshapes)


def batch_shardings(bshapes, mesh):
    def leaf(l):
        if l.shape[0] % sharding.dp_size(mesh) == 0:
            dp = sharding.dp_axes(mesh)
            lead = dp if len(dp) > 1 else dp[0]
            return (lead, *([None] * (l.dim() - 1)))
        return (None,) * l.dim()
    return tree_map(leaf, bshapes)
