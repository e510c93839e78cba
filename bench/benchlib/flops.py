"""The benchmark's own arithmetic: the operations a model requires for the
work of a window, and the operations and bytes of one call of each of the
port's kernels, from shapes alone. Each input is counted as read once and
each output as written once.

The LM counts are a copy of the port's `launch/roofline.active_params` and
`model_flops` (6 N D for training, 2 N D for a prefill), with two changes:
the attention term that they leave out (causal pairs only: 4 H hd pairs a
forward, three times that for training), and the embedding left out of N,
since a lookup is no product (the output head stays in). Recomputation is
not counted: it is work the model does not require.
"""
from __future__ import annotations

from typing import Dict, Tuple

from benchlib.device import PEAK_BYTES, PEAK_FLOPS


# ---------------------------------------------------------------------------
# LM (a configuration file's published keys)
# ---------------------------------------------------------------------------
def lm_layer_params(cfg: Dict) -> float:
    """Active parameters of one attention + MoE (or dense SwiGLU) layer."""
    d = cfg["hidden_size"]
    H, G = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // H
    attn = d * H * hd + 2 * d * G * hd + H * hd * d
    E = cfg.get("num_local_experts", 0)
    if E:
        k = cfg["num_experts_per_tok"] + cfg.get("num_shared_experts", 0)
        ffn = 3.0 * d * cfg["intermediate_size"] * k + d * E
    else:
        ffn = 3.0 * d * cfg["intermediate_size"]
    return attn + ffn


def lm_active_params(cfg: Dict) -> float:
    """Parameters a token passes through: every layer at top-k experts and
    the output head; not the embedding."""
    return (cfg["num_hidden_layers"] * lm_layer_params(cfg)
            + cfg["vocab_size"] * cfg["hidden_size"])


def causal_pairs(S: int) -> int:
    return S * (S + 1) // 2


def attention_flops(cfg: Dict, batch: int, S: int) -> float:
    """A forward's attention products over causal pairs, all layers."""
    H = cfg["num_attention_heads"]
    hd = cfg.get("head_dim") or cfg["hidden_size"] // H
    return 4.0 * H * hd * causal_pairs(S) * batch * cfg["num_hidden_layers"]


def lm_train_flops(cfg: Dict, sequences: int, S: int) -> float:
    """One train step over `sequences` rows of S tokens."""
    return (6.0 * lm_active_params(cfg) * sequences * S
            + 3.0 * attention_flops(cfg, sequences, S))


def lm_prefill_flops(cfg: Dict, batch: int, S: int) -> float:
    """One prefill of `batch` prompts of S tokens."""
    return (2.0 * lm_active_params(cfg) * batch * S
            + attention_flops(cfg, batch, S))


# ---------------------------------------------------------------------------
# LeNet5 fleet
# ---------------------------------------------------------------------------
def lenet_macs(cfg: Dict) -> Tuple[float, ...]:
    """Multiply-adds of one sample's forward, layer by layer: conv1, conv2,
    fc1, fc2, head."""
    img, k = cfg["image"], 5
    c1, c2 = cfg["conv_channels"]
    s1 = img - k + 1
    p1 = s1 // 2
    s2 = p1 - k + 1
    p2 = s2 // 2
    f1, d = cfg["fc_width"], cfg["d_feature"]
    return (s1 * s1 * c1 * k * k * cfg["in_channels"],
            s2 * s2 * c2 * k * k * c1,
            p2 * p2 * c2 * f1, f1 * d, d * cfg["num_classes"])


def lenet_flops(cfg: Dict, train_samples: int, forward_samples: int) -> float:
    """Training on `train_samples` samples (forward, the weights' gradient
    and, past the first layer, the input's gradient) and forwards of
    `forward_samples` more (uploads and eval)."""
    macs = lenet_macs(cfg)
    fwd = 2.0 * sum(macs)
    train = fwd + 2.0 * sum(macs) + 2.0 * sum(macs[1:])
    return train * train_samples + fwd * forward_samples


# ---------------------------------------------------------------------------
# the port's kernels: (operations, bytes) of one call
# ---------------------------------------------------------------------------
def disc_fwd_cost(N: int, B: int, C: int, M: int) -> Tuple[float, float]:
    """disc_loss forward: s (N, B, C) and q (N, M, C) float32, labels
    (N, B) int32, valid (N, M) bool in; loss, row max, log z (N, B) and
    h (N, B, M) float32 out. Softmax (max, exp, sum, scale: 4 C), p q^T
    (2 M C) and the loss (3 M) a sample."""
    ops = N * B * (4 * C + 2 * M * C + 3 * M)
    byt = 4 * (N * B * C + N * M * C) + 4 * N * B + N * M \
        + 4 * (3 * N * B + N * B * M)
    return ops, byt


def disc_bwd_cost(N: int, B: int, C: int, M: int) -> Tuple[float, float]:
    """disc_loss backward: g, row max, log z (N, B), s (N, B, C), q (N, M,
    C), h (N, B, M) float32, labels, valid in; ds (N, B, C) and dq (N, M,
    C) out. p (3 C), G (6 M), G q and G^T p (4 M C), the row sum (2 M) a
    sample."""
    ops = N * B * (3 * C + 8 * M + 4 * M * C)
    byt = 4 * (3 * N * B + N * B * C + N * M * C + N * B * M) \
        + 4 * N * B + N * M + 4 * (N * B * C + N * M * C)
    return ops, byt


def proto_accum_cost(N: int, n: int, d: int, C: int) -> Tuple[float, float]:
    """proto_accum: features (N, n, d) float32 and labels (N, n) int32 in;
    sums (N, C, d) and counts (N, C) float32 out; one add an element."""
    ops = N * n * (d + 1)
    byt = 4 * N * n * d + 4 * N * n + 4 * N * C * d + 4 * N * C
    return ops, byt


def flash_cost(B: int, S: int, H: int, G: int, hd: int, hv: int,
               elem: int) -> Tuple[float, float]:
    """Causal flash attention: q (B, S, H, hd), k (B, S, G, hd), v (B, S,
    G, hv) in, o (B, S, H, hv) out; QK^T and PV over causal pairs."""
    ops = 2.0 * B * H * (hd + hv) * causal_pairs(S)
    byt = elem * B * S * (H * hd + G * hd + G * hv + H * hv)
    return ops, byt


def least_seconds(ops: float, byt: float, dtype: str) -> float:
    """The roofline's least time: the larger of operations over the
    dtype's peak and bytes over HBM bandwidth."""
    return max(ops / PEAK_FLOPS[dtype], byt / PEAK_BYTES)
