"""Analytic roofline terms of a step on one NVIDIA H100, the port's own copy
of the analytic half of `repro/launch/roofline.py` (that module imports
numpy only; the port imports nothing of the reference).

  compute_s    = FLOPs a rank / peak bf16 FLOP/s       (989e12, dense)
  memory_s     = bytes a rank / HBM bandwidth          (3.35e12 B/s, HBM3)
  collective_s = collective bytes a rank / link rate   (450e9 B/s a way)

The constants are the H100 80GB HBM3's (SXM, 700 W): dense bf16 tensor-core
peak, HBM3 bandwidth, and NVLink 4's 450 GB/s each way.

Ported: `terms`, `model_flops`, `active_params` (with `_attn_params` and
`_ffn_active`), `active_params_total`, `memory_floor_bytes`,
`_cache_bytes`, and the depth-variant solver (`depth_variants`,
`real_counts`, `solve_linear`, `evaluate_linear`).

The counterpart of `collective_bytes`, which parses the collectives out of
XLA's compiled HLO text: PyTorch runs eagerly and has no compiled program
to read, so `CollectiveBytes` counts the collectives a run makes, as they
are made, by kind and by mesh axis, in the reference's dict. It sums every
operand of a collective: the reference reads only the first shape of
XLA's tuple all-reduces, so it counts a step's folded all-reduce over
"pod" as its first leaf (524,288 B, where cors moves 526,352 and fedavg
4,723,712 + 8, on the reduced TinyLlama over two pods).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = 989e12        # bf16 dense, H100 80GB HBM3 (SXM)
HBM_BW = 3.35e12           # bytes/s, HBM3
LINK_BW = 450e9            # bytes/s each way, NVLink 4


# the reference's kinds, and the functional collectives that are each
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute", "broadcast")
_FUNCTIONAL = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}


class CollectiveBytes(TorchDispatchMode):
    """The collectives a run makes while this mode is on, counted by kind
    and by the axis of `mesh` whose process group each runs over ("other"
    for a group of none of them): the operand bytes of every
    `torch.ops._c10d_functional` collective (through which DTensor
    redistributes), each of its operands summed, as the reference means
    them (an all-gather's local shard, a reduce-scatter's whole input).
    DTensor ops are let through first (`NotImplemented`), so that the
    collectives they issue on their local tensors are seen; staged through
    host memory (`ranks.stage_functional_collectives`) or not, under gloo
    or NCCL, the op is the same.

      with roofline.CollectiveBytes(mesh) as cb:
          step(state, batch, neg)
      cb.by_axis()            # {"pod": {"all-reduce": B, ..., "total",
                              #          "count"}, "data": ..., "model": ...}
      cb.by_axis(min_numel=2) # without the scalars (metric means)
    """

    def __init__(self, mesh):
        super().__init__()
        self.axes = {mesh.get_group(i).group_name: name
                     for i, name in enumerate(mesh.mesh_dim_names)}
        self.events: List[Tuple[str, str, int, int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        ns, _, name = str(func._schema.name).partition("::")
        if ns == "_c10d_functional" and name in _FUNCTIONAL:
            group = kwargs.get("group_name", args[-1])
            ts = args[0] if isinstance(args[0], (list, tuple)) else [args[0]]
            self.events.append((
                self.axes.get(group, "other"), _FUNCTIONAL[name],
                sum(t.numel() for t in ts),
                sum(t.numel() * t.element_size() for t in ts)))
        return func(*args, **kwargs)

    def by_axis(self, min_numel: int = 1) -> Dict[str, Dict[str, int]]:
        """{axis: {kind: operand bytes, ..., "total": their sum, "count":
        collectives}} of the collectives with at least `min_numel`
        elements, every axis of the mesh present."""
        out = {a: dict({k: 0 for k in KINDS}, total=0, count=0)
               for a in self.axes.values()}
        for axis, kind, numel, nbytes in self.events:
            if numel < min_numel:
                continue
            d = out.setdefault(axis, dict({k: 0 for k in KINDS}, total=0,
                                          count=0))
            d[kind] += nbytes
            d["total"] += nbytes
            d["count"] += 1
        return out


def terms(cost: Optional[dict], coll: Dict[str, int]) -> Dict[str, float]:
    flops = float((cost or {}).get("flops", 0.0))
    byts = float((cost or {}).get("bytes accessed", 0.0))
    t = {
        "flops": flops,
        "bytes": byts,
        "collective_bytes": float(coll.get("total", 0)),
        "compute_s": flops / PEAK_FLOPS,
        "memory_s": byts / HBM_BW,
        "collective_s": float(coll.get("total", 0)) / LINK_BW,
    }
    dom = max(("compute_s", "memory_s", "collective_s"), key=lambda k: t[k])
    t["bottleneck"] = dom.replace("_s", "")
    return t


def model_flops(cfg, shape, n_clients: int = 1) -> float:
    """6·N_active·D per step (training: fwd+bwd; decode: 2·N·tokens)."""
    n = active_params(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.mode == "train"
                                   else 1)
    mult = 6.0 if shape.mode == "train" else 2.0
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        mult = 2.0
    return mult * n * tokens


def active_params(cfg) -> float:
    """Parameter count with MoE counted at top-k active experts."""
    d, V = cfg.d_model, cfg.vocab_size
    total = 2.0 * V * d  # embed + head
    for kind in cfg.block_pattern:
        if kind == "attn":
            total += _attn_params(cfg) + _ffn_active(cfg)
        elif kind == "mamba":
            di, N, H = cfg.d_inner, cfg.ssm_state, cfg.mamba_heads
            total += d * (2 * di + 2 * N + H) + di * d
        elif kind == "mlstm":
            di = 2 * d
            total += d * 2 * di + 3 * di * di + di * d
        elif kind == "slstm":
            total += 4 * d * d + 4 * d * (d // cfg.num_heads) + 3 * d * d
    if cfg.shared_attn_period:
        total += _attn_params(cfg) + _ffn_active(cfg)
    if cfg.is_encoder_decoder:
        total += cfg.num_encoder_layers * (
            4 * d * cfg.num_heads * cfg.head_dim + 2 * d * cfg.d_ff)
        total += cfg.num_layers * (4 * d * cfg.num_heads * cfg.head_dim)
    return total


def _attn_params(cfg) -> float:
    d = cfg.d_model
    if cfg.is_mla:
        r_kv, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_dim,
                            cfg.qk_rope_dim, cfg.v_head_dim)
        H = cfg.num_heads
        q_in = cfg.q_lora_rank or d
        q = (d * cfg.q_lora_rank if cfg.q_lora_rank else 0) \
            + q_in * H * (dn + dr)
        kv = d * (r_kv + dr) + r_kv * H * (dn + dv)
        return q + kv + H * dv * d
    H, G, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return d * H * hd + 2 * d * G * hd + H * hd * d


def _ffn_active(cfg) -> float:
    d = cfg.d_model
    if cfg.num_experts:
        k = cfg.experts_per_token + cfg.num_shared_experts
        return 3.0 * d * cfg.moe_d_ff * k + d * cfg.num_experts
    return 3.0 * d * cfg.d_ff if cfg.mlp_kind == "swiglu" else 2.0 * d * cfg.d_ff


# ---------------------------------------------------------------------------
# per-layer costs from shallow depth variants
# ---------------------------------------------------------------------------
def depth_variants(cfg) -> Tuple[List, List[Dict[str, float]], List[str]]:
    """Returns (configs, count-dicts, unknown-names). Each config is a
    shallow full-width variant; counts give the per-kind layer multiplicity
    (plus the implicit fixed term)."""
    kinds = sorted(set(cfg.block_pattern))
    mk = lambda **kw: dataclasses.replace(cfg, **kw)
    if cfg.is_encoder_decoder:
        names = ["enc", "dec"]
        att = lambda n: ("attn",) * n
        cfgs = [mk(num_encoder_layers=1, num_layers=1, block_pattern=att(1)),
                mk(num_encoder_layers=2, num_layers=1, block_pattern=att(1)),
                mk(num_encoder_layers=1, num_layers=2, block_pattern=att(2))]
        counts = [{"enc": 1, "dec": 1}, {"enc": 2, "dec": 1},
                  {"enc": 1, "dec": 2}]
        return cfgs, counts, names
    if cfg.shared_attn_period:
        # zamba2: unknowns = mamba layer, shared-attn application
        names = ["mamba", "shared"]
        cfgs = [mk(num_layers=2, block_pattern=("mamba",) * 2,
                   shared_attn_period=2),            # 2 mamba + 1 shared
                mk(num_layers=3, block_pattern=("mamba",) * 3,
                   shared_attn_period=3),            # 3 mamba + 1 shared
                mk(num_layers=2, block_pattern=("mamba",) * 2,
                   shared_attn_period=1)]            # 2 mamba + 2 shared
        counts = [{"mamba": 2, "shared": 1}, {"mamba": 3, "shared": 1},
                  {"mamba": 2, "shared": 2}]
        return cfgs, counts, names
    if len(kinds) == 1:
        k = kinds[0]
        cfgs = [mk(num_layers=1, block_pattern=(k,)),
                mk(num_layers=2, block_pattern=(k, k))]
        counts = [{k: 1}, {k: 2}]
        return cfgs, counts, [k]
    # mixed pattern (xlstm): one variant per extra kind + base
    names = kinds
    base = tuple(kinds)
    cfgs = [mk(num_layers=len(base), block_pattern=base)]
    counts = [{k: 1 for k in kinds}]
    for k in kinds:
        pat = base + (k,)
        cfgs.append(mk(num_layers=len(pat), block_pattern=pat))
        c = {kk: 1 for kk in kinds}
        c[k] += 1
        counts.append(c)
    return cfgs, counts, names


def real_counts(cfg) -> Dict[str, float]:
    if cfg.is_encoder_decoder:
        return {"enc": cfg.num_encoder_layers, "dec": cfg.num_layers}
    c: Dict[str, float] = {}
    for k in cfg.block_pattern:
        c[k] = c.get(k, 0) + 1
    if cfg.shared_attn_period:
        c["shared"] = len(range(cfg.shared_attn_period, cfg.num_layers + 1,
                                cfg.shared_attn_period))
    return c


def solve_linear(counts: List[Dict[str, float]], names: List[str],
                 values: List[float]) -> Dict[str, float]:
    """Least-squares solve values_i = fixed + Σ counts_i[k]·coef[k]."""
    A = np.array([[1.0] + [c.get(k, 0.0) for k in names] for c in counts])
    b = np.array(values, dtype=np.float64)
    coef, *_ = np.linalg.lstsq(A, b, rcond=None)
    out = {"fixed": float(coef[0])}
    for k, v in zip(names, coef[1:]):
        out[k] = float(v)
    return out


def evaluate_linear(coefs: Dict[str, float], counts: Dict[str, float]) -> float:
    tot = coefs.get("fixed", 0.0)
    for k, n in counts.items():
        tot += coefs.get(k, 0.0) * n
    return max(0.0, tot)


# ---------------------------------------------------------------------------
# analytic memory floor a rank
# ---------------------------------------------------------------------------
def memory_floor_bytes(cfg, shape, n_devices: int, *, n_clients: int = 1,
                       dtype_bytes: int = 2) -> Dict[str, float]:
    """The least bytes a rank must hold: parameters, gradients and Adam's
    moments (training) or parameters and caches (serving), one activation
    checkpoint a layer boundary, all evenly sharded over `n_devices`."""
    P_count = active_params_total(cfg)
    out: Dict[str, float] = {}
    if shape.mode == "train":
        # params bf16 + grads bf16 + Adam m,v f32 (all sharded) per client
        per_client = P_count * (dtype_bytes * 2 + 8)
        out["states"] = n_clients * per_client / n_devices
        # one activation checkpoint per layer boundary
        tokens = shape.global_batch * shape.seq_len
        out["activations"] = (tokens * cfg.d_model * dtype_bytes
                              * cfg.num_layers) / n_devices
        out["logits"] = tokens * cfg.vocab_size * dtype_bytes / n_devices
        out["proto"] = cfg.vocab_size * (cfg.d_feature + 1) * 4 / n_devices
    else:
        out["params"] = P_count * dtype_bytes / n_devices
        if shape.mode == "decode":
            out["cache"] = _cache_bytes(cfg, shape, dtype_bytes) / n_devices
        else:
            tokens = shape.global_batch * shape.seq_len
            out["activations"] = (tokens * cfg.d_model * dtype_bytes * 2
                                  ) / n_devices
            out["cache"] = _cache_bytes(cfg, shape, dtype_bytes) / n_devices
    out["total"] = sum(out.values())
    return out


def active_params_total(cfg) -> float:
    """Total resident parameters (MoE counts ALL experts, not just top-k)."""
    n = active_params(cfg)
    if cfg.num_experts:
        d = cfg.d_model
        per_layer_extra = 3.0 * d * cfg.moe_d_ff * (
            cfg.num_experts - cfg.experts_per_token)
        n += per_layer_extra * sum(1 for k in cfg.block_pattern if k == "attn")
    return n


def _cache_bytes(cfg, shape, dtype_bytes: int) -> float:
    B = shape.global_batch
    S = shape.seq_len
    if getattr(cfg, "long_context_mode", "") == "swa" and S >= 1 << 19:
        S = cfg.swa_window
    total = 0.0
    for kind in cfg.block_pattern:
        if kind == "attn":
            if cfg.is_mla:
                total += B * S * (cfg.kv_lora_rank + cfg.qk_rope_dim)
            else:
                total += 2 * B * S * cfg.num_kv_heads * cfg.head_dim
        elif kind == "mamba":
            total += B * cfg.mamba_heads * cfg.mamba_head_dim * cfg.ssm_state * 2
        elif kind in ("mlstm", "slstm"):
            total += B * cfg.d_model * 8
    if cfg.shared_attn_period:
        n_sh = len(range(cfg.shared_attn_period, cfg.num_layers + 1,
                         cfg.shared_attn_period))
        total += n_sh * 2 * B * shape.seq_len * cfg.num_kv_heads * cfg.head_dim
    if cfg.is_encoder_decoder:
        total += 2 * B * cfg.encoder_seq * cfg.num_kv_heads * cfg.head_dim \
            * cfg.num_layers
    return total * dtype_bytes
