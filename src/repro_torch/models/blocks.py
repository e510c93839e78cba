"""Per-layer blocks (pre-norm residual) and segment grouping, the port of
`repro/models/blocks.py` for GQA attention layers with a dense MLP.

A model is a list of *segments*: consecutive layers of the same kind. The
reference stacks a segment's parameters on a leading layer axis and scans
it; here a segment is a plain list of per-layer parameter dicts, run by a
Python loop. Its attention cache keeps the reference's stacked layout,
(L, B, S, G, hd) for keys and values, and each layer reads and writes its
own slice of it. MLA, MoE, mamba, mLSTM and sLSTM layers raise
`NotImplementedError`: their modules come with the other LM families.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.nn import attention, layers

_LATER = "is not ported yet (ROADMAP.md, queue 1: other LM families)"


def check_supported(cfg, kind: str) -> None:
    """Raise `NotImplementedError` for a layer kind the port lacks."""
    if kind != "attn":
        raise NotImplementedError(f"{kind} layers {_LATER}")
    if cfg.is_mla:
        raise NotImplementedError(f"MLA attention (nn/mla.py) {_LATER}")
    if cfg.num_experts:
        raise NotImplementedError(f"MoE layers (nn/moe.py) {_LATER}")


# ---------------------------------------------------------------------------
# single-layer init / apply
# ---------------------------------------------------------------------------
def init_block(gen: torch.Generator, cfg, kind: str, dtype):
    check_supported(cfg, kind)
    dev = gen.device
    return {
        "norm1": layers.init_norm(cfg.norm_kind, cfg.d_model, dtype, dev),
        "attn": attention.init_gqa(gen, cfg.d_model, cfg.num_heads,
                                   cfg.num_kv_heads, cfg.head_dim, dtype),
        "norm2": layers.init_norm(cfg.norm_kind, cfg.d_model, dtype, dev),
        "mlp": layers.init_mlp(cfg.mlp_kind, gen, cfg.d_model, cfg.d_ff,
                               dtype),
    }


def apply_block(p, cfg, kind: str, x, positions, *, window: int = 0,
                mode: str = "train", cache=None, cache_index=None,
                masked: bool = False):
    """mode: train | prefill | decode. Returns (x, aux, new_cache); in
    decode, `cache` is this layer's (k, v), updated in place. aux (the MoE
    balance loss in the reference) is 0.0 for the dense layers ported."""
    check_supported(cfg, kind)
    h = layers.apply_norm(cfg.norm_kind, p["norm1"], x, cfg.norm_eps)
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
              head_dim=cfg.head_dim, rope_kind=cfg.rope_kind,
              rope_theta=cfg.rope_theta)
    new_cache = None
    if mode == "decode":
        ck, cv = cache
        y, nk, nv = attention.gqa_decode(
            p["attn"], h, ck, cv, positions, cache_index=cache_index,
            window=window, masked=masked, **kw)
        new_cache = (nk, nv)
    elif mode == "prefill":
        y, new_cache = attention.gqa_block(p["attn"], h, positions,
                                           causal=True, window=window,
                                           return_kv=True, **kw)
    else:
        y = attention.gqa_block(p["attn"], h, positions, causal=True,
                                window=window, **kw)
    x = x + y
    h2 = layers.apply_norm(cfg.norm_kind, p["norm2"], x, cfg.norm_eps)
    x = x + layers.apply_mlp(cfg.mlp_kind, p["mlp"], h2)
    return x, 0.0, new_cache


# ---------------------------------------------------------------------------
# segments
# ---------------------------------------------------------------------------
def segments_of(cfg) -> List[Tuple[str, int]]:
    """[(kind, n_layers), ...] grouping consecutive same-kind layers,
    additionally split at shared-attention insertion points (zamba2)."""
    segs: List[Tuple[str, int]] = []
    for i, kind in enumerate(cfg.block_pattern):
        boundary = (cfg.shared_attn_period
                    and i > 0 and i % cfg.shared_attn_period == 0)
        if segs and segs[-1][0] == kind and not boundary:
            segs[-1] = (kind, segs[-1][1] + 1)
        else:
            segs.append((kind, 1))
    return segs


def init_segments(gen: torch.Generator, cfg, dtype) -> List[List[Dict[str, Any]]]:
    """-> one list of per-layer parameter dicts for each segment."""
    return [[init_block(gen, cfg, kind, dtype) for _ in range(n)]
            for kind, n in segments_of(cfg)]


def run_segment(seg_params, cfg, kind: str, x, positions, *, window: int,
                mode: str, cache=None, cache_index=None, masked: bool = False):
    """Run a segment's layers in order. In prefill the new caches are
    stacked to (L, B, S, G, hd); in decode `cache` is that stacked pair and
    each layer updates its slice in place. Returns (x, aux_sum, cache)."""
    aux = 0.0
    ks, vs = [], []
    for i, lp in enumerate(seg_params):
        lc = None if cache is None else (cache[0][i], cache[1][i])
        x, a, nc = apply_block(lp, cfg, kind, x, positions, window=window,
                               mode=mode, cache=lc, cache_index=cache_index,
                               masked=masked)
        aux = aux + a
        if mode == "prefill":
            ks.append(nc[0])
            vs.append(nc[1])
    if mode == "prefill":
        return x, aux, (torch.stack(ks), torch.stack(vs))
    return x, aux, cache
