"""Serving steps, the port of `repro/launch/serve.py`: prefill (build the KV
caches and the first logits) and decode (one token against the cache).
CoRS is a training-time technique; serving is the plain model, so these
steps carry no prototype traffic. The reference's sharding helpers come
with the multi-device slice (ROADMAP.md, queue 1, slice 9).
"""
from __future__ import annotations

from repro_torch.models import lm
from repro_torch.types import ModelConfig, ShapeConfig


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
