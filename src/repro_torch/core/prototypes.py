"""Per-class feature-representation statistics (the objects CoRS shares); the
port of `repro/core/prototypes.py`.

  - global prototypes t^c : inter-client mean feature per class  (L_KD)
  - observations      t^c_m: intra-client averages of n_avg same-class
                             features                             (L_disc)

The per-class accumulation runs through the hand-written proto_accum kernel
on the card (`kernels/ops.py`); the observation draw is a weighted sum that
stays plain torch, as the reference leaves it to XLA. Both take an optional
leading client axis (the vectorized engine's fleet): one kernel launch, one
batched draw.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import sharding
from repro_torch.kernels import ops, ref


class ProtoState(NamedTuple):
    """Running per-class sums. sum: (..., C, d') f32; count: (..., C) f32."""
    sum: torch.Tensor
    count: torch.Tensor

    @property
    def num_classes(self) -> int:
        return self.sum.shape[-2]


def init_state(num_classes: int, d_feature: int, device,
               clients: Optional[int] = None) -> ProtoState:
    """Zero sums, (C, d') and (C,), or with `clients` (N, C, d') and (N, C)."""
    lead = () if clients is None else (clients,)
    return ProtoState(torch.zeros(*lead, num_classes, d_feature, device=device),
                      torch.zeros(*lead, num_classes, device=device))


def accumulate(state: ProtoState, features, labels) -> ProtoState:
    """features (..., n, d'); labels (..., n) int. Adds per-class
    sums/counts: one proto_accum launch. DTensors are first placed as the
    kernel's wrapper declares (`ops.proto_accum_placed`); a plain state is
    then added as a replicated DTensor."""
    if sharding.is_dtensor(features):
        features, labels = ops.proto_accum_placed(features, labels)
    s, c = ops.proto_accum(features.float(), labels, state.num_classes)
    return ProtoState(sharding.replicated_like(state.sum, s) + s,
                      sharding.replicated_like(state.count, c) + c)


def means(state: ProtoState, fallback: Optional[torch.Tensor] = None):
    """-> (C, d') per-class means; classes with zero count get `fallback`
    rows (default zeros)."""
    m = state.sum / state.count.clamp(min=1.0)[:, None]
    if fallback is not None:
        m = torch.where(state.count[:, None] > 0, m, fallback)
    return m


def merge(*states: ProtoState) -> ProtoState:
    """Inter-client aggregation (the server's only computation, Alg. 1)."""
    return ProtoState(sum(s.sum for s in states),
                      sum(s.count for s in states))


def psum_merge(state: ProtoState, group=None) -> ProtoState:
    """On-mesh aggregation over the client axis (the relay as an
    all-reduce): the sums and counts summed over the ranks of `group`, a
    process group or a client mesh (its "clients" group; None is the
    default group). A collective: every rank of the group calls it. New
    tensors; the vectorized engine gathers the per-client sums instead
    (`relay/placement.exchange`), so that the merge adds them in the
    unsharded order."""
    import torch.distributed as dist
    if hasattr(group, "get_group"):
        group = group.get_group("clients")
    s, c = state.sum.clone(), state.count.clone()
    dist.all_reduce(s, group=group)
    dist.all_reduce(c, group=group)
    return ProtoState(s, c)


def observations(prio, features, labels, num_classes: int, n_avg: int):
    """Paper's t^c_m: for each class c, one average over n_avg same-class
    samples per row of `prio`.

    prio (m_up, n): per-draw sample priorities (the reference draws them with
    `jax.random.uniform`, `prototypes.py:90`); each draw keeps the n_avg
    highest-priority samples of every class. features (n, d'); labels (n,).
    Classes with fewer than n_avg samples average what is present; empty
    classes give zero rows and a False validity. A leading client axis on
    all three batches the draws.

    Returns obs (..., m_up, C, d') f32, valid (..., C) bool.
    """
    feats = features.float()
    onehot = ref.one_hot(labels, num_classes)                # (..., n, C)
    order = torch.argsort(-prio, dim=-1, stable=True)[..., None]   # (..., m, n, 1)
    ranked = torch.take_along_dim(onehot[..., None, :, :], order, dim=-2)
    rank_in_class = torch.cumsum(ranked, -2) * ranked        # (..., m, n, C)
    w = ((rank_in_class > 0) & (rank_in_class <= n_avg)).float()
    s = w.transpose(-1, -2) @ torch.take_along_dim(feats[..., None, :, :], order,
                                                   dim=-2)   # (..., m, C, d')
    cnt = w.sum(-2).clamp(min=1.0)
    return s / cnt[..., None], onehot.sum(-2) > 0
