"""Serving steps, the port of `repro/launch/serve.py`'s single-device half:
prefill (build the caches and the first logits) and decode (one token
against the cache), and the abstract inputs of each step as `meta` tensors
(shapes and dtypes only). CoRS is a training-time technique; serving is
the plain model, so these steps carry no prototype traffic. The
reference's sharding helpers come with the multi-device slice (ROADMAP.md,
queue 1, slice 9); its encoder-decoder branches with Whisper.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import lm
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
        out = lm.forward(params, cfg, batch, mode="prefill")
        return {"logits": out["logits"][:, -1:, :], "caches": out["caches"]}
    return prefill_step


def make_decode_step(cfg: ModelConfig, *, window: int = 0):
    def decode_step(params, batch, caches, cache_index=None,
                    masked: bool = False):
        out = lm.decode_step(params, cfg, batch, caches, window=window,
                             cache_index=cache_index, masked=masked)
        return {"logits": out["logits"], "caches": out["caches"]}
    return decode_step


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------
def params_shapes(cfg: ModelConfig):
    """The parameters of `lm.init_lm` as `meta` tensors."""
    return lm.init_lm(None, cfg)


def serve_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """A step's batch as `meta` tensors: tokens (B, S) int32, or embeddings
    (B, S, d) with M-RoPE positions (B, S, 3) int32 where the rope is
    M-RoPE; S is 1 but for a prefill shape."""
    lm._check_supported(cfg)
    B = shape.global_batch
    S = shape.seq_len if shape.mode == "prefill" else 1
    if cfg.input_kind == "tokens":
        return {"tokens": torch.empty(B, S, dtype=torch.int32, device=META)}
    batch = {"embeddings": torch.empty(B, S, cfg.d_model,
                                       dtype=getattr(torch, cfg.dtype),
                                       device=META)}
    if cfg.rope_kind == "mrope":
        batch["positions"] = torch.empty(B, S, 3, dtype=torch.int32,
                                         device=META)
    return batch


def cache_shapes(cfg: ModelConfig, shape: ShapeConfig):
    """`lm.init_cache` at this shape (its window included) as `meta`
    tensors."""
    return lm.init_cache(cfg, shape.global_batch, shape.seq_len,
                         window=decode_window(cfg, shape), device=META)
