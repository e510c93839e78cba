"""LOCALUPDATE (paper Algorithm 2), model-agnostic; the port of
`repro/core/client.py`.

A client is (apply, head): `apply(params, x) -> (features, logits)` and
`head(params) -> (W, b)` exposing the linear classifier tau_u used by the
discriminator. The reference's two `lax.scan`s (epochs x batches) are Python
loops here. `loss_fn` reads no randomness in any mode, so a local update is
deterministic given the parameters and the teacher.

`stacked=True` is the vectorized engine's form, the counterpart of
`jax.vmap` over these functions: every parameter, batch and teacher entry
carries a leading client axis. The model runs under `torch.func.vmap` over
the stacked parameters; the losses (and so the kernels) take the client
axis explicitly, outside the vmap, one launch for the fleet; one gradient
of the sum of the N clients' losses is each client's own gradient, since
the clients share no parameter.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from repro_torch.core import losses, prototypes
from repro_torch.optim import adam_update
from repro_torch.types import CollabConfig, TrainConfig


# The trainers' modes: CoRS, the paper's Table 1 baselines (federated
# distillation, FedAvg, independent learning) and CL, which is il on one
# client holding all the data.
MODES = ("cors", "fd", "fedavg", "il", "cl")


@dataclass(frozen=True)
class ClientSpec:
    apply: Callable  # (params, x) -> (features (B,d'), logits (B,C))
    head: Callable   # params -> (W (d',C), b (C,) | None)


def bucket_key(spec: ClientSpec, params) -> Tuple:
    """Stackability key of one client: the spec plus every parameter's name,
    shape and dtype (the reference's pytree structure + leaf shapes)."""
    return (spec, tuple((k, tuple(p.shape), str(p.dtype))
                        for k, p in sorted(params.items())))


def bucketize(specs: Sequence[ClientSpec],
              params_list: Sequence) -> List[Tuple[ClientSpec, List[int]]]:
    """Group clients into stackable buckets: (spec, client-id list) pairs in
    FIRST-APPEARANCE order, client-id order within a bucket. The sequential
    trainer uploads in this order (the reference's relay-write order)."""
    if len(specs) != len(params_list):
        raise ValueError("one spec per parameter set")
    buckets: Dict[Tuple, List[int]] = {}
    for i, (s, p) in enumerate(zip(specs, params_list)):
        buckets.setdefault(bucket_key(s, p), []).append(i)
    return [(k[0], ids) for k, ids in buckets.items()]


def _apply(spec: ClientSpec, stacked: bool):
    return torch.func.vmap(spec.apply) if stacked else spec.apply


def loss_fn(spec: ClientSpec, params, batch, teacher, ccfg: CollabConfig,
            stacked: bool = False):
    """One mini-batch of Algorithm 2's inner loop -> (total, metrics):
    L_CE, plus L_KD and L_disc in cors mode, plus the fd loss on the mean
    logits in fd mode; il, cl and fedavg train on L_CE alone.

    teacher: dict(global_protos (C,d'), valid_g (C,), obs (M,C,d'),
    valid_o (C,), obs_pick (int: which m to use), mean_logits (C,C)).
    stacked: every argument has a leading client axis (obs_pick an (N,)
    tensor), and total and metrics are (N,)."""
    x, y = batch["x"], batch["y"]
    feats, logits = _apply(spec, stacked)(params, x)
    l_ce = losses.ce_loss(logits, y)
    metrics = {"ce": l_ce}
    total = l_ce
    if ccfg.mode == "cors":
        w, b = spec.head(params)
        l_kd = losses.kd_loss(feats, teacher["global_protos"], y,
                              valid=teacher["valid_g"])
        obs, pick = teacher["obs"], teacher.get("obs_pick", 0)
        if stacked:                                          # (N, C, d')
            obs_m = obs[torch.arange(obs.shape[0], device=obs.device), pick]
        else:
            obs_m = obs[int(pick)]                           # (C, d')
        l_disc = losses.disc_loss(feats, obs_m, y, w, b,
                                  valid=teacher["valid_o"],
                                  student_logits=logits)
        total = total + ccfg.lambda_kd * l_kd + ccfg.lambda_disc * l_disc
        metrics.update(kd=l_kd, disc=l_disc,
                       mi_bound=losses.mi_lower_bound(
                           l_disc, ccfg.num_classes - 1))
    elif ccfg.mode == "fd":
        l_fd = losses.fd_loss(logits, teacher["mean_logits"], y,
                              valid=teacher["valid_g"])
        total = total + ccfg.lambda_kd * l_fd
        metrics["fd"] = l_fd
    metrics["total"] = total
    return total, metrics


def empty_teacher(ccfg: CollabConfig, device) -> Dict:
    """A no-op teacher (il, cl and fedavg modes), with the keys and shapes
    of a relay policy's `sample_teacher`."""
    C, d = ccfg.num_classes, ccfg.d_feature
    return {"global_protos": torch.zeros(C, d, device=device),
            "valid_g": torch.zeros(C, dtype=torch.bool, device=device),
            "obs": torch.zeros(max(1, ccfg.m_down), C, d, device=device),
            "valid_o": torch.zeros(C, dtype=torch.bool, device=device),
            "obs_pick": 0,
            "mean_logits": torch.zeros(C, C, device=device)}


def make_local_update_fn(spec: ClientSpec, ccfg: CollabConfig,
                         tcfg: TrainConfig, stacked: bool = False):
    """fn(params, opt_state, batches, teacher) -> (params, opt_state,
    metrics). `batches` = {"x": (n_batches, bs, ...), "y": (n_batches, bs)},
    run for E local epochs (Algorithm 2). Metrics are those of the last
    batch, as 0-d tensors, with the step's global gradient norm.

    stacked: params, Adam moments, batches ({"x": (N, n_batches, bs, ...),
    "y": (N, n_batches, bs)}) and teacher carry a leading client axis;
    metrics are (N,), the gradient norm each client's own."""

    def run(params, opt_state, batches, teacher):
        n = batches["y"].shape[1 if stacked else 0]
        keys = sorted(params)
        metrics = zero_metrics(ccfg)
        for _ in range(tcfg.local_epochs):
            for j in range(n):
                p = {k: v.detach().requires_grad_(True)
                     for k, v in params.items()}
                batch = ({"x": batches["x"][:, j], "y": batches["y"][:, j]}
                         if stacked else
                         {"x": batches["x"][j], "y": batches["y"][j]})
                total, metrics = loss_fn(spec, p, batch, teacher, ccfg,
                                         stacked)
                grads = dict(zip(keys, torch.autograd.grad(
                    total.sum() if stacked else total, [p[k] for k in keys])))
                metrics = {k: v.detach() for k, v in metrics.items()}
                metrics["grad_norm"] = torch.sqrt(sum(
                    torch.square(grads[k]).reshape(total.shape + (-1,)).sum(-1)
                    for k in keys))
                params, opt_state = adam_update(
                    params, grads, opt_state, lr=tcfg.learning_rate,
                    b1=tcfg.beta1, b2=tcfg.beta2, eps=tcfg.eps)
        return params, opt_state, metrics

    return run


def zero_metrics(ccfg: CollabConfig) -> Dict:
    """The metrics record of a client that ran no step: all-zero floats with
    exactly the keys `loss_fn` emits for this mode."""
    m = {"ce": 0.0, "total": 0.0, "grad_norm": 0.0}
    if ccfg.mode == "cors":
        m.update(kd=0.0, disc=0.0, mi_bound=0.0)
    elif ccfg.mode == "fd":
        m["fd"] = 0.0
    return m


@torch.no_grad()
def compute_uploads(spec: ClientSpec, params, data_x, data_y,
                    ccfg: CollabConfig, prio, stacked: bool = False) -> Dict:
    """End-of-round uploads (Algorithm 1): the client's per-class sums (for
    t-bar) and M_up observations (for the L_disc buffers), and in fd mode
    its per-class logit sums (`logit_proto`, for the mean logits). prio
    (m_up, n): the observation draw's priorities (see
    `prototypes.observations`). stacked: all N clients' uploads at once,
    each entry with a leading client axis (one proto_accum launch for the
    fleet, two in fd mode)."""
    feats, logits = _apply(spec, stacked)(params, data_x)
    lead = feats.shape[0] if stacked else None

    def sums(rows):
        return prototypes.accumulate(
            prototypes.init_state(ccfg.num_classes, rows.shape[-1],
                                  rows.device, lead), rows, data_y)

    obs, valid = prototypes.observations(prio, feats, data_y,
                                         ccfg.num_classes, ccfg.n_avg)
    out = {"proto": sums(feats), "obs": obs, "valid": valid}
    if ccfg.mode == "fd":
        out["logit_proto"] = sums(logits)
    return out
