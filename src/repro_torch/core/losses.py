"""The paper's objective (Eq. 6): L = L_CE + lambda_KD L_KD + lambda_disc L_disc;
the port of `repro/core/losses.py`.

L_disc (Eq. 5/7) uses the model's own classifier tau_u as the discriminator:
h(s, t) = <softmax(tau_u(s)), softmax(tau_u(t))>, trained as a binary
"same class?" classifier with one positive and K = C - 1 negatives. On the
card it runs through the hand-written disc_loss kernels (`kernels/ops.py`).

Every loss takes an optional leading client axis (the vectorized engine's
stacked fleet): each is a mean over its own client's samples, a scalar for
one client and (N,) for N, the counterpart of `jax.vmap` over the
reference's per-client losses.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops


def ce_loss(logits, labels):
    """Mean cross-entropy over the samples. logits (..., B, C); labels
    (..., B) int -> (...)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0].mean(-1)


def kd_loss(features, global_protos, labels, valid=None):
    """L_KD = E||s_i - t^{y_i}||^2 with the mean-per-dim reduction of the
    reference (see its docstring for why the paper's lambda needs it).
    features (..., B, d'), global_protos (..., C, d'), labels (..., B),
    valid (..., C) -> (...)."""
    lab = labels.long()
    t = torch.take_along_dim(global_protos, lab[..., None], dim=-2)   # (..., B, d')
    d2 = ((features.float() - t) ** 2).mean(-1)
    w = torch.ones_like(d2)
    if valid is not None:
        w = w * torch.take_along_dim(valid.float(), lab, dim=-1)
    return (d2 * w).sum(-1) / w.sum(-1).clamp(min=1.0)


def _tau(head_w, head_b, x):
    z = x.float() @ head_w.float()
    if head_b is not None:
        z = z + head_b.float()[..., None, :]
    return z


def hhat_matrix(student_logits, teacher_logits):
    """h(s, t) for all pairs: (..., B, C_s) softmax . (..., M, C_s) softmax
    -> (..., B, M)."""
    p = torch.softmax(student_logits.float(), dim=-1)
    q = torch.softmax(teacher_logits.float(), dim=-1)
    return p @ q.transpose(-1, -2)


def disc_loss(features, obs, labels, head_w, head_b=None, valid=None,
              student_logits=None):
    """Paper-faithful L_disc with K = C - 1 (Eq. 7, Algorithm 2): a scalar,
    or (N,) with a leading client axis on every argument.

    features (B, d') student reps; obs (C, d') one downloaded observation per
    class; labels (B,); head_w (d', C), head_b (C,): the client's own tau_u.
    valid (C,): classes with no observation are excluded from both roles.
    With a client axis the N teacher products are one batched product and
    the kernels one launch each for the fleet.

    The teacher probabilities softmax(tau_u(obs)) are computed here and
    handed to the per-sample kernel, whose gradient flows into them as well
    (tau_u is the client's own head). The masked mean over samples whose
    label has an observation then gives the reference's jnp branch
    (`repro/core/losses.py:79-89`).
    """
    s_logits = (_tau(head_w, head_b, features)
                if student_logits is None else student_logits)
    q = torch.softmax(_tau(head_w, head_b, obs), dim=-1)    # (..., C, C)
    per = ops.disc_loss(s_logits, q, labels, valid)          # (..., B)
    C = obs.shape[-2]
    v = (torch.ones(per.shape[:-1] + (C,), device=per.device) if valid is None
         else valid.float())
    sample_valid = torch.take_along_dim(v, labels.long(), dim=-1)  # drop s with no t^y
    return (per * sample_valid).sum(-1) / sample_valid.sum(-1).clamp(min=1.0)


def mi_lower_bound(disc, K: int):
    """Theorem 1: I(Phi_s, Phi_t) >= log K - L_disc."""
    return math.log(float(K)) - disc


def fd_loss(logits, mean_logits, labels, valid=None):
    """Federated Distillation baseline (Jeong et al. 18): the mean squared
    distance between the student's logits and the fleet's per-class mean
    logits of the label. logits (..., B, C), mean_logits (..., C, C),
    labels (..., B), valid (..., C) -> (...)."""
    lab = labels.long()
    t = torch.take_along_dim(mean_logits, lab[..., None], dim=-2)   # (..., B, C)
    d2 = ((logits.float() - t) ** 2).mean(-1)
    if valid is not None:
        w = torch.take_along_dim(valid.float(), lab, dim=-1)
        return (d2 * w).sum(-1) / w.sum(-1).clamp(min=1.0)
    return d2.mean(-1)
