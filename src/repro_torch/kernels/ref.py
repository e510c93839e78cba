"""Plain PyTorch versions of the port's kernels (the correctness ground truth).

Each function has the contract of the CUDA kernel beside it (`csrc/`) and of
the reference's jnp oracle (`repro/kernels/ref.py`). `kernels/ops.py` runs
these for CPU tensors; `chip_smoke.py` holds each kernel against them on the
card. disc_loss and proto_accum also take a leading client axis on every
argument, computed as one batched product (the vectorized engine's form).
"""
from __future__ import annotations

import torch

EPS = 1e-7
NEG_INF = -1e30


def one_hot(labels, n: int):
    """(..., B) int -> (..., B, n) f32; labels outside [0, n) give a zero
    row, as `jax.nn.one_hot` does."""
    return (labels.long()[..., None]
            == torch.arange(n, device=labels.device)).float()


def proto_accum(features, labels, num_classes: int):
    """features (..., n, d) -> per-class sums (..., C, d) f32 and counts
    (..., C) f32. Labels outside [0, C) contribute nothing."""
    onehot = one_hot(labels, num_classes)
    return onehot.transpose(-1, -2) @ features.float(), onehot.sum(-2)


def valid_f32(valid, M: int, device):
    """(..., M) f32 teacher-row weights: valid, or ones (M,)."""
    if valid is None:
        return torch.ones(M, dtype=torch.float32, device=device)
    return valid.float()


def disc_loss_fwd(student_logits, teacher_probs, labels, valid=None):
    """Per-sample CoRS discriminator loss (Eq. 7) and what its backward needs.

    student_logits s (..., B, C); teacher_probs q (..., M, C), rows already
    softmaxed; labels (..., B) index the M axis; valid (..., M) masks
    teacher rows. The leading axes (none, or the clients) batch.
    Returns loss (..., B) f32, row_max (..., B), log_z (..., B) (softmax(s)
    = exp(s - row_max - log_z)) and h_raw (..., B, M) = softmax(s) @ q^T
    before the clip to [EPS, 1 - EPS].
    """
    s = student_logits.float()
    q = teacher_probs.float()
    row_max = s.max(-1).values
    e = torch.exp(s - row_max[..., None])
    z = e.sum(-1)
    h_raw = (e / z[..., None]) @ q.transpose(-1, -2)
    h = h_raw.clamp(EPS, 1.0 - EPS)
    M = q.shape[-2]
    pos = one_hot(labels, M)
    v = valid_f32(valid, M, s.device)
    per_pair = -(pos * torch.log(h) + (1.0 - pos) * torch.log1p(-h)) * v[..., None, :]
    return per_pair.sum(-1), row_max, torch.log(z), h_raw


def disc_loss(student_logits, teacher_probs, labels, valid=None):
    """Per-sample loss (..., B) f32; equals `repro/kernels/ref.py:disc_loss`
    (under `jax.vmap` for a client axis)."""
    return disc_loss_fwd(student_logits, teacher_probs, labels, valid)[0]


def disc_loss_bwd(g, student_logits, teacher_probs, labels, valid, row_max,
                  log_z, h_raw):
    """Analytic gradient of `sum_i g_i * disc_loss(s, q)_i` -> (ds (..., B,
    C), dq (..., M, C)), batched over the leading axes.

        G[i,m] = g_i v_m kappa_im (-pos_im / h_im + (1 - pos_im) / (1 - h_im))
        ds     = p * (G @ q - sum_m G_im h_raw_im)
        dq     = G.T @ p

    with h the clipped h_raw and kappa 0 where the clip is active, which is
    `jax.grad` of `jnp.clip` away from exact ties.
    """
    s = student_logits.float()
    q = teacher_probs.float()
    p = torch.exp(s - row_max[..., None] - log_z[..., None])
    M = q.shape[-2]
    pos = one_hot(labels, M)
    v = valid_f32(valid, M, s.device)
    kappa = ((h_raw > EPS) & (h_raw < 1.0 - EPS)).float()
    h = h_raw.clamp(EPS, 1.0 - EPS)
    G = (g.float()[..., None] * v[..., None, :] * kappa
         * (-pos / h + (1.0 - pos) / (1.0 - h)))
    gh = (G * h_raw).sum(-1)
    ds = p * (G @ q - gh[..., None])
    dq = G.transpose(-1, -2) @ p
    return ds, dq


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """q (B, Sq, H, hd); k (B, Sk, G, hd), v (B, Sk, G, hv), H % G == 0 ->
    (B, Sq, H, hv) in q's dtype (hv != hd: MLA's prefill, whose values are
    narrower than its queries and keys). GQA by reshaping q to (B, Sq, G,
    H/G, hd): query head h reads KV head h // (H/G). q is scaled by hd^-0.5 in float32, scores and softmax
    in float32; the causal mask keeps q_pos >= k_pos, both from 0 (masked
    scores -1e30), as `repro/kernels/ref.py:flash_attention`. A window
    W > 0 also masks q_pos - k_pos >= W, the sliding-window mask of
    `repro/nn/attention.py:full_attention` (W = 0: none)."""
    B, Sq, H, hd = q.shape
    G, Sk = k.shape[2], k.shape[1]
    qf = q.reshape(B, Sq, G, H // G, hd).float() * (hd ** -0.5)
    s = torch.einsum("bqghd,bkgd->bgqhk", qf, k.float())
    if causal or window:
        diff = (torch.arange(Sq, device=q.device)[:, None]
                - torch.arange(Sk, device=q.device)[None, :])
        mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
        if causal:
            mask &= diff >= 0
        if window:
            mask &= diff < window
        s = s.masked_fill(~mask[None, None, :, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgqhk,bkgd->bgqhd", p, v.float())
    return o.permute(0, 2, 1, 3, 4).reshape(B, Sq, H, v.shape[-1]).to(q.dtype)
