"""Per-layer blocks (pre-norm residual) and segment grouping, the port of
`repro/models/blocks.py`: attention layers (GQA or MLA, with a dense MLP or
MoE) and the mamba, mLSTM and sLSTM kinds.

A model is a list of *segments*: consecutive layers of the same kind. The
reference stacks a segment's parameters on a leading layer axis and scans
it; here a segment is a plain list of per-layer parameter dicts, run by a
Python loop. Its cache keeps the reference's stacked layout, each kind its
own (`lm.init_cache`): GQA (K, V) (L, B, S, G, hd); MLA one latent tensor
(L, B, S, r_kv + dr); mamba (conv (L, B, cw-1, C), h (L, B, H, P, N));
mLSTM (conv, C); sLSTM (c, n, m, h). Each layer reads its slice. In
decode, attention caches are written in place; the recurrent states come
back as new tensors, which are written into the layer's slice. In train
mode each layer of every kind is rematerialised by `REMAT_POLICY`, as the
reference's `jax.checkpoint` does, and the layer's MoE balance loss comes
out of the remat beside x, as the reference carries `aux` through it.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import sharding
from repro_torch.nn import attention, layers, mla, moe, ssm, xlstm
from repro_torch.tree import tree_map

# Activation-checkpoint policy for the per-layer remat in train mode:
#   "full" - recompute each layer in backward (the reference's default)
#   "dots" - save the products with a weight, recompute the rest (the
#            reference's jax.checkpoint_policies.dots_with_no_batch_dims_saveable)
#   "none" - no remat (more live memory, no recompute)
REMAT_POLICY = "full"

# "dots": the ops whose outputs a layer's selective checkpoint saves. A
# product with a weight, (..., d) @ (d, f), folds to 2-D and dispatches
# `aten.mm` (`aten.addmm` with a bias); attention's score and value
# products and MoE's expert einsums have a batch dim (JAX's dot_general
# batch dims), dispatch `aten.bmm` / `aten.baddbmm`, and are recomputed.
DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in DOTS_SAVED
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _wrap_remat(fn):
    """fn(x) -> (x, aux), rematerialised by `REMAT_POLICY`."""
    if REMAT_POLICY == "full":
        return lambda x: checkpoint(fn, x, use_reentrant=False)
    if REMAT_POLICY == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                _dots_policy)
        return lambda x: checkpoint(fn, x, use_reentrant=False,
                                    context_fn=ctx)
    if REMAT_POLICY == "none":
        return fn
    raise ValueError(f"REMAT_POLICY {REMAT_POLICY!r}: the policies are "
                     f'"full", "dots" and "none"')


# ---------------------------------------------------------------------------
# single-layer init / apply
# ---------------------------------------------------------------------------
def init_block(gen: torch.Generator, cfg, kind: str, dtype):
    dev = layers.gen_device(gen)
    p: Dict[str, Any] = {"norm1": layers.init_norm(cfg.norm_kind, cfg.d_model,
                                                   dtype, dev)}
    if kind == "attn":
        if cfg.is_mla:
            p["attn"] = mla.init_mla(gen, cfg, dtype)
        else:
            p["attn"] = attention.init_gqa(gen, cfg.d_model, cfg.num_heads,
                                           cfg.num_kv_heads, cfg.head_dim,
                                           dtype)
        p["norm2"] = layers.init_norm(cfg.norm_kind, cfg.d_model, dtype, dev)
        if cfg.num_experts:
            p["moe"] = moe.init_moe(gen, cfg.d_model, cfg.num_experts,
                                    cfg.moe_d_ff, cfg.num_shared_experts,
                                    dtype)
        else:
            p["mlp"] = layers.init_mlp(cfg.mlp_kind, gen, cfg.d_model,
                                       cfg.d_ff, dtype)
    elif kind == "mamba":
        p["mamba"] = ssm.init_mamba2(gen, cfg, dtype)
    elif kind == "mlstm":
        p["mlstm"] = xlstm.init_mlstm(gen, cfg, dtype)
    elif kind == "slstm":
        p["slstm"] = xlstm.init_slstm(gen, cfg, dtype)
    else:
        raise ValueError(kind)
    return p


def _attn(p, cfg, h, positions, *, window, mode, cache, cache_index, masked):
    """The attention half of an attn layer -> (y, new_cache)."""
    if cfg.is_mla:
        if mode == "decode":
            return mla.mla_decode(p, cfg, h, cache, positions,
                                  cache_index=cache_index, masked=masked)
        if mode == "train":
            return mla.mla_block(p, cfg, h, positions, window=window,
                                 mode="train"), None
        return mla.mla_block(p, cfg, h, positions, window=window,
                             return_cache=True)
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
              head_dim=cfg.head_dim, rope_kind=cfg.rope_kind,
              rope_theta=cfg.rope_theta)
    if mode == "decode":
        ck, cv = cache
        y, nk, nv = attention.gqa_decode(
            p, h, ck, cv, positions, cache_index=cache_index, window=window,
            masked=masked, **kw)
        return y, (nk, nv)
    if mode == "prefill":
        return attention.gqa_block(p, h, positions, causal=True,
                                   window=window, return_kv=True, **kw)
    return attention.gqa_block(p, h, positions, causal=True, window=window,
                               mode="train", **kw), None


def apply_block(p, cfg, kind: str, x, positions, *, window: int = 0,
                mode: str = "train", cache=None, cache_index=None,
                masked: bool = False):
    """mode: train | prefill | decode. Returns (x, aux, new_cache): aux is
    the MoE balance loss (0.0 for other layers); in decode, `cache` is this
    layer's, an attention cache updated in place, a recurrent state
    returned anew."""
    h = layers.apply_norm(cfg.norm_kind, p["norm1"], x, cfg.norm_eps)
    decode = mode == "decode"
    aux, new_cache = 0.0, None
    if kind == "attn":
        y, new_cache = _attn(p["attn"], cfg, h, positions, window=window,
                             mode=mode, cache=cache, cache_index=cache_index,
                             masked=masked)
        x = x + y
        h2 = layers.apply_norm(cfg.norm_kind, p["norm2"], x, cfg.norm_eps)
        if cfg.num_experts:
            y2, aux = moe.moe_block(p["moe"], h2, num_experts=cfg.num_experts,
                                    k=cfg.experts_per_token,
                                    cf=cfg.capacity_factor,
                                    num_shared=cfg.num_shared_experts)
        else:
            y2 = layers.apply_mlp(cfg.mlp_kind, p["mlp"], h2)
        return x + y2, aux, new_cache
    if kind == "mamba":
        if decode:
            y, new_cache = ssm.mamba2_decode(p["mamba"], cfg, h, cache)
        elif mode == "train":
            y = ssm.mamba2_block(p["mamba"], cfg, h)
        else:
            y, new_cache = ssm.mamba2_block(p["mamba"], cfg, h,
                                            return_cache=True)
    elif kind in ("mlstm", "slstm"):
        block = xlstm.mlstm_block if kind == "mlstm" else xlstm.slstm_block
        if mode == "train":
            y = block(p[kind], cfg, h)
        else:
            y, new_cache = block(p[kind], cfg, h, return_cache=not decode,
                                 cache=cache, decode=decode)
    else:
        raise ValueError(kind)
    return x + y, aux, new_cache


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


def _write(dst, src):
    """A recurrent state written into its slice of the stacked cache; on a
    mesh placed as that slice first (a state computed whole over a mesh dim
    that splits the cache is cut there, no communication)."""
    if sharding.is_dtensor(src) and tuple(src.placements) != tuple(
            dst.placements):
        src = src.redistribute(dst.device_mesh, dst.placements)
    dst.copy_(src)


def run_segment(seg_params, cfg, kind: str, x, positions, *, window: int,
                mode: str, cache=None, cache_index=None, masked: bool = False):
    """Run a segment's layers in order. In train mode each layer is
    rematerialised by `REMAT_POLICY`, its aux with it. In prefill the
    layers' new caches are stacked on a leading layer axis; in decode
    `cache` is that stacked cache: layer i reads slice i of each leaf, and
    a recurrent state comes back written into it. Returns (x, aux_sum,
    cache)."""
    aux = 0.0
    new = []
    for i, lp in enumerate(seg_params):
        if mode == "train":
            fn = lambda xx, lp=lp: apply_block(lp, cfg, kind, xx, positions,
                                               window=window)[:2]
            x, a = _wrap_remat(fn)(x)
            aux = aux + a
            continue
        lc = None if cache is None else tree_map(lambda a: a[i], cache)
        x, a, nc = apply_block(lp, cfg, kind, x, positions, window=window,
                               mode=mode, cache=lc, cache_index=cache_index,
                               masked=masked)
        aux = aux + a
        if mode == "prefill":
            new.append(nc)
        elif kind != "attn":               # attention wrote in place
            tree_map(lambda a, n: _write(a[i], n), cache, nc)
    if mode == "prefill":
        return x, aux, tree_map(lambda *ls: torch.stack(ls), *new)
    return x, aux, cache
