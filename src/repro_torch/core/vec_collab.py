"""Vectorized multi-client engine: all clients advance through ONE batched
round step; the port of `repro/core/vec_collab.py` for synchronous fleets.

The sequential `CollabTrainer` steps clients in a Python loop: N dispatches
per phase, each a few small device operations. This engine stacks the
clients' parameters, Adam state and data along a leading client axis and
runs the round (relay sampling, local updates, uploads, one relay write and
merge) on the stacks: the model under `torch.func.vmap` over the stacked
parameters, the losses with an explicit client axis, so that disc_loss's
forward and backward kernels are launched once a local step for the whole
fleet and proto_accum once a round. Given the same draws and equal-size
partitions the two engines evolve identical relay bookkeeping and weights
equal up to float32 summation order (tests/test_torch_vec_collab.py).

Participation (`relay/participation.py`): the schedule's (N,) mask is a
device input of the round step. Schedules with a static participant count
k (uniform_k, cyclic) run COMPACTED: the step gathers the k participants'
parameters, Adam state, data and draws into a (k, ...) block with
`index_select`, runs the model, the losses and the kernels on k clients
instead of N, and scatters the block back with `index_copy`.
Variable-count schedules (bernoulli, adaptive) run full-width and mask:
absent clients' parameters and Adam state are kept by `freeze_absent`,
their metrics zeroed, their uploads zero-weighted and their ring rows
dropped without consuming slots; the relay write is kept only if someone
took part (`keep_if` on the device, never a host branch on a device
value).

Heterogeneous fleets (different client models, a CoRS selling point) run
BUCKETED: clients are grouped into stackable buckets (`client.bucketize`),
each bucket runs its own full-width masked step (`make_bucket_update_step`)
against the SAME round-start relay state, and one shared commit
(`make_relay_commit`) appends all buckets' rows in bucket order (the order
the sequential engine uploads in) and merges once; a round with no
participant skips the commit on the host, where the mask lives. Weights
never cross buckets, so fedavg needs one bucket.

The round step never waits on the card: the draws of a round are stacked
and moved to the device before it (for all N clients, indexed by client
id; absent clients' draws go unused), the relay's ring write has fixed
shapes, and the host reads the metrics and the accuracies once each, after
it. It is the counterpart of the reference's single jitted step
(`_round_step._cache_size() == 1`); capturing it in a CUDA graph is queued
in ROADMAP. The mask and the compaction index are the static input
buffers such a capture needs.

Asynchrony (`FleetConfig.clock` with D_max > 0, cors and fd): uploads
commit late through the event log of `relay/events.py`. A round-r upload
with commit delay d parks in a fixed-shape pending buffer (N, D_max, ...)
and is appended in round r + d, in event order, stamped with its birth
clock, by ONE `events.commit_and_park` inside the round step
(`make_async_round_step`), or inside the shared commit of a mixed fleet
(`make_async_relay_commit`, which runs every round: parked uploads may be
due when nobody trains). The commit set is not the participant set, so an
asynchronous fleet runs full width, never compacted. The round index,
the delays and the mask are device inputs; the host learns each round's
commits from a payload-free `events.CommitMirror` and never reads the
pending buffer. A D_max = 0 clock is the synchronous fleet: no pending
buffer, and compaction stays.

Download lag (`FleetConfig.download_clock`, cors and fd): every client
reads its teachers and global prototypes from its own snapshot, d(client,
round) rounds staler than the round-start state, out of the ring of the
last H_max = d_max + 1 post-merge states (`relay/history.py`) that the
step pushes to every round. The per-client snapshots are one gather of
every ring leaf by a (k,) slot vector, and the policy's sampler runs on
each client's snapshot under `torch.func.vmap`. Lag composes with
compaction (only participants read: the step gathers their delays with
the rest of the block) and with asynchrony. Any download clock, also
d_max = 0, goes through the ring.

Population scale (`FleetConfig.arrivals`, `sim/population.py`): the N
clients are the seats of a cohort table. Each round its view gives the
mask over seats, the external id of each seat, which becomes the step's
`ids` device input (ring owner tags and shard routing; seat churn changes
no shape), and the owners it LRU-evicted, whose ring slots one
`policy.evict_owners` call on the device invalidates before the step. A
streaming fleet runs full width. The sharded relay (`relay/shards.py`)
enters the step only through `policy.reduce_uploads`, which the upload
phase, the shared bucket commit and the asynchronous commit take in place
of their own weighted sum, and through states whose leaves lead with the
shard axis (also in the history ring).

This engine runs every mode of the sequential engine (cors, fd, fedavg,
il, cl), the relay policies flat, per_class, staleness and sharded, every
participation schedule, heterogeneous buckets, asynchrony, download lag
and streaming arrivals. fedavg's weight average is part of the round step,
in float32, as the reference computes it.

A client mesh (`FleetConfig.mesh`, `sharding.client_mesh(W)`, one process
a rank under `torch.distributed`): every rank builds the trainer from the
same seed and the same full client list, and keeps its contiguous block of
N / W clients (parameters, Adam state, data, batches, draws, pending
positions), as `relay/placement.py` declares them CLIENT_SHARDED. It holds
the relay state, the history ring and all host-side bookkeeping (schedule,
clocks, cohort table, commit mirror, ledger, history) whole, computed the
same on every rank. The round body is the unsharded one: the only place
where client-sharded values cross ranks is `placement.exchange`, once a
round, on the commit payload (the per-client uploads with their masks,
owners and stamps, gathered in rank order = upload order), after which
every rank reduces the per-client sums in the unsharded order and runs the
same append and merge; fedavg's exchange is each rank's weighted sum. Off
a mesh `exchange` is the identity. Static-k compaction pads each rank's
block to min(k, N / W) with absent clients (masked rows, which consume no
ring slot); a mixed fleet's bucket whose size W divides is client-sharded,
any other is run whole by every rank and enters the exchange once. The
round record's metrics and accuracies are gathered after the step
(`placement.gather`), so every rank's record equals the one-rank engine's;
`client_params` is then a collective.

Telemetry (`telemetry=`, `repro_torch.obs`): a build flag of the
synchronous, compacted, asynchronous and lagged round steps, which then
return the round's `obs.RoundTelemetry` after the metrics, computed on the
device from the state the step holds (with it off the step is exactly the
one built without it); a mixed fleet computes it in one call after its
shared commit. The host reads it once a round, in one copy
(`obs.to_record`). Trace spans: evict, round_step (or bucket_steps and
commit), eval.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs, sharding, sim
from repro_torch.core import baselines, client as client_lib, collab, comm, \
    prototypes
from repro_torch.device import resolve_device
from repro_torch.optim import adam_init
from repro_torch.relay import events, history, participation, placement
from repro_torch.relay.participation import freeze_absent, keep_if
from repro_torch.tree import tree_map
from repro_torch.types import CollabConfig, FleetConfig, TrainConfig


def _stack(trees: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


# ---------------------------------------------------------------------------
# Round-phase builders, as in the reference: the fused round step is composed
# of these.
# ---------------------------------------------------------------------------
def make_teacher_phase(policy, ccfg: CollabConfig, lagged: bool = False):
    """Phase 1 (downlink): every client's teacher sampled from the relay in
    one batched draw of the policy (cors, fd), a broadcast no-op teacher
    otherwise. Returns `teachers(rstate, ids, noise, picks) -> teacher dict
    (k, ...)`.

    `lagged=True`, download lag: `teachers(hist, ids, noise, picks, dl)`
    samples client i's teacher from its own snapshot `history.read_at(hist,
    dl[i])`. The snapshots are one gather of every ring leaf by the (k,)
    slot vector (a state whose leaves lead with k), and the policy's
    sampler runs on a fleet of one under `torch.func.vmap` over (snapshot,
    id, noise, pick): the reference's vmap of `sample_teacher . read_at`.
    `dl` is a device input: no host read."""
    m_down = max(1, ccfg.m_down)

    if lagged:
        def one(state, i, nz, pk):
            t = policy.sample_teachers(state, i[None], m_down, nz[None],
                                       pk[None])
            return {k: v[0] for k, v in t.items()}

        per_snapshot = torch.func.vmap(one)

        def teachers_lagged(hist, ids, noise, picks, dl):
            return per_snapshot(history.read_at(hist, dl), ids, noise, picks)

        return teachers_lagged

    def teachers(rstate, ids, noise, picks):
        if ccfg.mode in collab.RELAY_MODES:
            return policy.sample_teachers(rstate, ids, m_down, noise, picks)
        k = ids.shape[0]
        et = client_lib.empty_teacher(ccfg, ids.device)
        et["obs_pick"] = torch.zeros(k, dtype=torch.long, device=ids.device)
        return {n: v if n == "obs_pick" else v.expand(k, *v.shape)
                for n, v in et.items()}

    return teachers


def make_client_upload_phase(spec: client_lib.ClientSpec, ccfg: CollabConfig):
    """Phase 3a, per-client form: the stacked `compute_uploads` with no
    cross-client reduction. Returns `uploads_of(params, data_x, data_y,
    prio, ids) -> dict(obs (k, m, C, d'), valid (k, C), psum (k, C, d'),
    pcnt (k, C), [lsum (k, C, C), lcnt (k, C) in fd mode], owner (k,)
    int32)`."""

    def uploads_of(p_s, dx, dy, prio, ids_s):
        u = client_lib.compute_uploads(spec, p_s, dx, dy, ccfg, prio,
                                       stacked=True)
        out = {"obs": u["obs"], "valid": u["valid"],
               "psum": u["proto"].sum, "pcnt": u["proto"].count,
               "owner": ids_s.to(torch.int32)}
        if "logit_proto" in u:
            out["lsum"], out["lcnt"] = u["logit_proto"]
        return out

    return uploads_of


def make_upload_phase(spec: client_lib.ClientSpec, ccfg: CollabConfig):
    """Phase 3a of a synchronous round: the per-client pieces of
    `make_client_upload_phase` and the participation mask, `uploads_of(
    params, data_x, data_y, prio, ids, mask) -> dict(..., mask (k,))`. The
    cross-client reduction is the commit's, after the round's exchange
    (`make_relay_commit`), so that on a mesh the sums are added in the
    unsharded order."""
    per_client = make_client_upload_phase(spec, ccfg)

    def uploads_of(p_s, dx, dy, prio, ids_s, sub_mask):
        return dict(per_client(p_s, dx, dy, prio, ids_s), mask=sub_mask)

    return uploads_of


def _reduce(policy, u, sum_key: str, count_key: str):
    """One stack's committing prototype (or fd logit) sums: absent clients
    zero-weighted and the rest summed over the client axis, or, for a
    policy with `reduce_uploads` (cohort shards), segmented by owner."""
    wf = u["mask"].to(torch.float32)
    s, c = u[sum_key], u[count_key]
    if policy.reduce_uploads is not None:
        return policy.reduce_uploads(s, c, wf, u["owner"])
    return prototypes.ProtoState((s * wf[:, None, None]).sum(0),
                                 (c * wf[:, None]).sum(0))


def _concat(payloads):
    """The stacks' per-client pieces on one client axis, in bucket order."""
    if len(payloads) == 1:
        return payloads[0]
    return {k: torch.cat([p[k] for p in payloads]) for k in payloads[0]}


def make_relay_commit(policy, lagged: bool = False, mesh=None,
                      layout=placement.CLIENT_SHARDED, sizes=None):
    """Phase 3b: the round's single relay write. `commit(rstate, payloads,
    *hist, extra=None)` takes the stacks' uploads (`make_upload_phase`, one
    payload a stack, in bucket = upload order) and exchanges them
    (`placement.exchange`, THE round's exchange: on a mesh `layout` places
    their concatenated client axis on the ranks and `sizes` are the stacks'
    full sizes). It then reduces each stack's prototype sums (and, in fd
    mode, logit sums) and merges them, appends every observation row in
    upload order through the policy in one write and runs ONE merge, kept
    only if someone took part (`keep_if`, on the gathered mask).

    -> (new state, [history ring with it pushed, when `lagged`], the
    gathered `extra`): `extra` is client-sharded leaves of the same layout
    (telemetry's inputs) that ride the exchange."""
    spans = None
    if sizes is not None and len(sizes) > 1:
        starts = np.cumsum([0] + list(sizes[:-1]))
        spans = list(zip(starts.tolist(), sizes))

    def commit(rstate, payloads, *hist, extra=None):
        u, extra = placement.exchange((_concat(payloads), extra), mesh, layout)
        parts = ([u] if spans is None else
                 [{k: v.narrow(0, a, n) for k, v in u.items()}
                  for a, n in spans])
        proto = prototypes.merge(*[_reduce(policy, p, "psum", "pcnt")
                                   for p in parts])
        logit = (prototypes.merge(*[_reduce(policy, p, "lsum", "lcnt")
                                    for p in parts])
                 if "lsum" in u else None)
        k, m_real = u["obs"].shape[:2]
        new = policy.append(
            rstate, u["obs"].reshape(k * m_real, *u["obs"].shape[2:]),
            u["valid"][:, None].expand(k, m_real, -1).reshape(k * m_real, -1),
            u["owner"][:, None].expand(k, m_real).reshape(-1),
            u["mask"][:, None].expand(k, m_real).reshape(-1))
        new = policy.merge_round(new, proto, logit)
        new = keep_if(u["mask"].any(), new, rstate)
        out = (new, history.push(hist[0], new)) if lagged else (new,)
        return out + (extra,)

    return commit


def make_async_relay_commit(policy, lagged: bool = False, mesh=None,
                            layout=placement.CLIENT_SHARDED):
    """Phase 3b of an asynchronous fleet: `commit(rstate, pending,
    payloads, round_idx, delays, mask, *hist, extra=None) -> (rstate,
    pending, [hist], extra)` concatenates the payloads' PER-CLIENT pieces
    (`make_client_upload_phase`, one a bucket, in bucket = upload order)
    and runs ONE `events.commit_and_park`, whose commit payload is the
    round's exchange on `mesh` (`layout` places the upload positions);
    `delays` and `mask` come in upload order, the pending buffer's. It runs
    every round, since parked uploads may be due when nobody trains.
    `lagged=True` takes the history ring last and pushes the new state
    (unconditionally). `extra` rides the exchange and comes back gathered,
    last."""

    def commit(rstate, pending, payloads, round_idx, delays, mask, *hist,
               extra=None):
        out = events.commit_and_park(
            policy, rstate, pending, _concat(payloads), round_idx, delays,
            mask, mesh, layout, extra=extra)
        rstate, pending = out[:2]
        shared = out[2] if extra is not None else None
        if lagged:
            return rstate, pending, history.push(hist[0], rstate), shared
        return rstate, pending, shared

    return commit


def fedavg_average(params, mask, mesh=None, extra=None):
    """fedavg's exchange inside the round step: every present client's
    weights replaced by the float32 average over the present clients,
    sum(p . w) / n_present, as the reference's vectorized engine computes
    it; absent clients keep theirs. The exchange's payload is this rank's
    weighted sums and present count, one row a rank (on a mesh the
    model-size all-reduce, added in rank order; off it, one row).
    -> (new tensors, none shared; the gathered `extra`)."""
    wf = mask.to(torch.float32)
    lead = lambda p: (-1,) + (1,) * (p.dim() - 1)
    part = {"n": wf.sum()[None],
            "s": {k: (p.float() * wf.reshape(lead(p))).sum(0)[None]
                  for k, p in params.items()}}
    part, extra = placement.exchange((part, extra), mesh)
    denom = part["n"].sum(0).clamp(min=1.0)

    def avg(k, p):
        a = (part["s"][k].sum(0) / denom).to(p.dtype)
        return torch.where(mask.reshape(lead(p)), a.expand_as(p), p)

    return {k: avg(k, v) for k, v in params.items()}, extra


def _telemetry_parts(metrics, mask, dl=None, pending=None, round_idx=None,
                     delays=None):
    """The client-sharded inputs of the round's telemetry, by client (or
    upload position): mask, last-batch loss and gradient norm, download
    delays, and under asynchrony the commit delays and the pending slots
    before and after this round's commit. On a mesh they ride the round's
    exchange, so that the telemetry reads the whole fleet."""
    parts = {"mask": mask, "loss": metrics["total"],
             "gnorm": metrics["grad_norm"]}
    if dl is not None:
        parts["dl"] = dl
    if delays is not None:
        parts["delays"] = delays
    if pending is not None:
        parts.update(live=pending.live, commit=pending.commit,
                     birth=pending.birth,
                     live_post=events.live_after(pending, round_idx, delays,
                                                 mask))
    return parts


def _pending_views(parts):
    """(pre-commit, post-commit) pending buffers for `round_telemetry`,
    which reads only their slots' live, commit and birth."""
    empty = events.PendingState(*([None] * len(events.PendingState._fields)))
    return (empty._replace(live=parts["live"], commit=parts["commit"],
                           birth=parts["birth"]),
            empty._replace(live=parts["live_post"]))


def _round_telemetry(prev_state, new_state, n: int, parts, round_idx=None):
    """A homogeneous step's RoundTelemetry from the exchanged parts."""
    pend = {}
    if "live" in parts:
        pre, post = _pending_views(parts)
        pend = dict(pending=post, pending_pre=pre, round_idx=round_idx,
                    delays=parts["delays"])
    return obs.round_telemetry(
        prev_state, new_state, n, mask=parts["mask"],
        loss_parts=(parts["loss"],), gnorm_parts=(parts["gnorm"],),
        mask_parts=(parts["mask"],), dl=parts.get("dl"), **pend)


def make_bucket_update_step(spec: client_lib.ClientSpec, ccfg: CollabConfig,
                            tcfg: TrainConfig, policy,
                            per_client_payload: bool = False,
                            lagged: bool = False):
    """Phases 1-3a of one stack of clients of one model, full-width and
    masked, against a FIXED relay state: downlink, local updates (absent
    clients' parameters and Adam state frozen, their metrics zeroed) and the
    upload payload. The relay write (3b) is not here, so that every bucket
    of a mixed fleet reads the same round-start state and one shared commit
    follows. Returns `step(params, opt, rstate, batches, data_x, data_y,
    ids, noise, picks, prio, mask) -> (params, opt, metrics, payload)`;
    `payload` is None outside cors and fd: the per-client pieces and mask
    of `make_upload_phase`, or with `per_client_payload` the per-client
    pieces of `make_client_upload_phase` that the event log parks and
    commits.

    `lagged=True`: the `rstate` argument is the history ring, and a
    trailing `dl` (k,) gives each client's snapshot depth. The ring is read
    only; the commit pushes to it."""
    local_update = client_lib.make_local_update_fn(spec, ccfg, tcfg,
                                                   stacked=True)
    teachers = make_teacher_phase(policy, ccfg, lagged)
    uploads_of = (make_client_upload_phase(spec, ccfg) if per_client_payload
                  else make_upload_phase(spec, ccfg))

    def step(params, opt, rstate, batches, data_x, data_y, ids, noise,
             picks, prio, mask, *dl):
        teacher = teachers(rstate, ids, noise, picks, *dl)
        new_p, new_o, metrics = local_update(params, opt, batches, teacher)
        params = freeze_absent(mask, new_p, params)
        opt = freeze_absent(mask, new_o, opt)
        metrics = {k: torch.where(mask, v, 0.0) for k, v in metrics.items()}
        payload = None
        if ccfg.mode in collab.RELAY_MODES:
            payload = (uploads_of(params, data_x, data_y, prio, ids)
                       if per_client_payload else
                       uploads_of(params, data_x, data_y, prio, ids, mask))
        return params, opt, metrics, payload

    return step


def make_async_round_step(spec: client_lib.ClientSpec, ccfg: CollabConfig,
                          tcfg: TrainConfig, policy, lagged: bool = False,
                          telemetry: bool = False, mesh=None):
    """The homogeneous ASYNCHRONOUS round step (bounded-delay uploads,
    `relay/events.py`), full width: phases 1-2 as in the synchronous step,
    then the per-client uploads and ONE `events.commit_and_park`. Returns
    `step(params, opt, rstate, pending, batches, data_x, data_y, ids, noise,
    picks, prio, mask, delays, round_idx) -> (params, opt, rstate, pending,
    metrics)`; `mask`, `delays` (N,) int32 and `round_idx` (0-d int32) are
    device inputs, so the step reads nothing back to the host. On `mesh`
    the client-sharded inputs are this rank's block, and the commit
    payload is the round's one exchange.

    `lagged=True` adds download lag: two trailing inputs `(hist, dl)`, each
    client's teacher from its own snapshot, the new state pushed to the
    ring, which is returned before the metrics.

    `telemetry=True` (a build flag: off, the step is exactly the one built
    without it) appends the round's `obs.RoundTelemetry` as the last
    output, from the round-start and committed relay states, the pending
    buffer's slots before and after the commit and this round's mask and
    delays, which ride the commit's exchange."""
    bucket_step = make_bucket_update_step(spec, ccfg, tcfg, policy,
                                          per_client_payload=True,
                                          lagged=lagged)
    commit = make_async_relay_commit(policy, lagged, mesh)

    def step(params, opt, rstate, pending, batches, data_x, data_y, ids,
             noise, picks, prio, mask, delays, round_idx, *lag):
        params, opt, metrics, payload = bucket_step(
            params, opt, lag[0] if lagged else rstate, batches, data_x,
            data_y, ids, noise, picks, prio, mask, *lag[1:])
        parts = None if not telemetry else _telemetry_parts(
            metrics, mask, dl=lag[1] if lagged else None, pending=pending,
            round_idx=round_idx, delays=delays)
        *out, parts = commit(rstate, pending, [payload], round_idx, delays,
                             mask, *lag[:1], extra=parts)
        tail = () if not telemetry else (_round_telemetry(
            rstate, out[0], mask.shape[0], parts, round_idx),)
        return (params, opt) + tuple(out) + (metrics,) + tail

    return step


def make_eval_hits(spec: client_lib.ClientSpec):
    """Stacked-client eval: logits of the whole client stack for one test
    chunk and the per-client hit counts (k,), on the device."""
    logits = torch.func.vmap(lambda p, x: spec.apply(p, x)[1], in_dims=(0, None))

    @torch.no_grad()
    def hits(P, x, y):
        return (logits(P, x).argmax(-1) == y[None]).sum(-1)

    return hits


@dataclass
class ClientBucket:
    """One stackable group of a mixed fleet: one model's clients'
    parameters, Adam state and data stacked on a leading axis of len(ids),
    and the bucket's step and eval. `whole` are the bucket's client ids
    (ascending) and `ids` those this rank holds: all of them, or off a
    client-sharded bucket's rank block on a mesh; they tag the ring rows
    and pick the draws and mask entries."""
    ids: np.ndarray
    whole: np.ndarray
    ids_t: torch.Tensor
    params: Dict[str, torch.Tensor]
    opt: object
    batches: Dict[str, torch.Tensor]
    data_x: torch.Tensor
    data_y: torch.Tensor
    step: Callable
    eval_hits: Callable


class VectorizedCollabTrainer:
    """Counterpart of the sequential `CollabTrainer`: the same constructor
    (specs, parameters, data parts, test data, configs, seed, fleet, draws,
    device), `run_round` record schema, ledger and history. A homogeneous
    fleet is one stack and one round step (compacted under fixed-k
    schedules); a mixed fleet runs one step a bucket around a shared relay
    commit. Client datasets are trimmed to the shortest partition of their
    bucket so they stack; pass equal-size partitions for parity with the
    sequential engine. On a client mesh (`FleetConfig.mesh`) every rank
    constructs it alike and runs every round; see the module docstring."""

    def __init__(self, specs, params_list: Sequence[Dict[str, torch.Tensor]],
                 client_data: Sequence[Tuple], test_data: Tuple,
                 ccfg: CollabConfig, tcfg: TrainConfig, seed: int = 0,
                 fleet: FleetConfig = None, draws=None, device=None,
                 telemetry=None):
        fleet = fleet if fleet is not None else FleetConfig()
        self.policy = collab.check_setup(ccfg, fleet)
        self._obs = collab.RunObserver(telemetry)
        self.telemetry, self._span = self._obs.config, self._obs.span
        self._telem = self._obs.metrics
        if isinstance(specs, client_lib.ClientSpec):
            specs = [specs] * len(params_list)
        if not len(specs) == len(params_list) == len(client_data):
            raise ValueError("one spec, parameter set and data part per client")
        buckets = client_lib.bucketize(specs, params_list)
        self.hetero = len(buckets) > 1
        if self.hetero and ccfg.mode == "fedavg":
            raise ValueError(
                "fedavg averages whole weight vectors, which needs one "
                f"shared model; got {len(buckets)} client buckets")
        self.device = dev = resolve_device(device)
        self.ccfg, self.tcfg = ccfg, tcfg
        self.n_clients = N = len(params_list)
        self.mesh = _check_mesh(fleet.mesh, N)
        self.clock = sim.get_clock(fleet.clock, seed=seed)
        # a streaming fleet: N seats of a cohort table, which owns
        # participation; its evictions hit the relay before each round step
        self.arrivals = collab.check_arrivals(ccfg, fleet, self.clock,
                                              len(buckets))
        self._cohort = (self.arrivals.table(N) if self.arrivals is not None
                        else None)
        self.schedule = (None if self._cohort is not None else
                         participation.get_schedule(fleet.participation,
                                                    seed=seed,
                                                    clock=self.clock))
        if self._cohort is not None:
            self._evict = self.policy.evict_owners
        self._upload_order = [i for _, ids in buckets for i in ids]
        # this rank's part of every stack: a homogeneous fleet and a bucket
        # whose size the mesh divides are client-sharded (a rank block), any
        # other bucket is held whole; off a mesh everything is whole
        tags = [_stack_placement(self.mesh, len(ids)) for _, ids in buckets]
        self._local_ids = []
        for tag, (_, ids) in zip(tags, buckets):
            lo, hi = placement.rank_block(self.mesh, len(ids), tag)
            self._local_ids.append(list(ids[lo:hi]))
        self._local_order = [i for ids in self._local_ids for i in ids]
        self._layout = (placement.Blocks(
            [(t, len(ids)) for t, ids in zip(tags, self._local_ids)])
            if self.hetero else tags[0])
        sizes = [len(ids) for _, ids in buckets]
        self._spans = list(zip(np.cumsum([0] + sizes[:-1]).tolist(), sizes))
        self.relay_state = self.policy.init_state(ccfg, ccfg.d_feature, seed,
                                                  n_clients=N, device=dev)
        if self.mesh is not None:
            _held_whole(self.policy.out_spec(self.relay_state), "relay state")
        as_t = lambda a: torch.as_tensor(np.asarray(a)).to(dev)
        self.test_x, self.test_y = as_t(test_data[0]), as_t(test_data[1])
        self.draws = draws if draws is not None else collab.TorchDraws(seed)
        self.ledger = comm.CommLedger()
        self.history: List[Dict] = []
        # asynchrony: a pending buffer indexed by upload position (this
        # rank's), and the host's mirror of the commit order; a D_max = 0
        # clock is the synchronous fleet. Download lag: the snapshot ring,
        # under any download clock. Only the relay modes commit and
        # download.
        relay_mode = ccfg.mode in collab.RELAY_MODES
        self._async = (self.clock is not None and self.clock.d_max > 0
                       and relay_mode)
        self.dl_clock = sim.get_download_clock(fleet.download_clock,
                                               seed=seed)
        self._lagged = self.dl_clock is not None and relay_mode
        if self._async:
            self.pending = events.init_pending(
                len(self._local_order), self.clock.d_max, ccfg.m_up,
                ccfg.num_classes, ccfg.d_feature, fd=ccfg.mode == "fd",
                device=dev)
            self._commit_mirror = events.CommitMirror()
        if self._lagged:
            self._h_max = self.dl_clock.d_max + 1
            self.hist = history.init(self.relay_state, self._h_max)
            if self.mesh is not None:
                _held_whole(history.out_spec(self.hist), "history ring")
        if self.hetero:
            self._init_bucketed(buckets, params_list, client_data)
            return

        self.spec = buckets[0][0]
        self._lo, self._hi = self._local_ids[0][0], self._local_ids[0][-1] + 1
        mine = slice(self._lo, self._hi)
        self.data_x, self.data_y, self.batches, self.params, self.opt_state \
            = self._stack_clients(params_list[mine], client_data[mine],
                                  min(len(x) for x, _ in client_data))
        self._model_size = baselines.num_params(
            {k: v[0] for k, v in self.params.items()})
        self._ids = torch.arange(self._lo, self._hi, dtype=torch.int32,
                                 device=dev)
        # static-k compaction: only when the schedule's participant count is
        # fixed and a strict subset (a full-size gather and scatter-back
        # would tax every full round for nothing), and never under
        # asynchrony, whose commits are not the participants' uploads; a
        # streaming fleet runs full width (its seat ids are a device input).
        # On a mesh each rank's block is min(k, N / W) wide, padded with
        # absent clients, so that its shape does not change with the round
        fixed_k = self.schedule.fixed_k if self.schedule is not None else None
        self._k_active = (fixed_k if fixed_k is not None and not self._async
                          else N)
        self._k_block = min(self._k_active, self._hi - self._lo)
        self._round_step = (
            make_async_round_step(self.spec, ccfg, self.tcfg, self.policy,
                                  self._lagged, self._telem, self.mesh)
            if self._async else self._make_round_step())
        self._eval_hits = make_eval_hits(self.spec)

    # ------------------------------------------------------------------
    def _stack_clients(self, params_list, client_data, n_common: int):
        """Data trimmed to `n_common` samples (the shortest partition of the
        whole stack, this rank's part or not), batched views, parameters and
        fresh Adam state (one step count a client), all with a leading
        client axis, on the device."""
        dev = self.device
        data_x = torch.stack([torch.as_tensor(np.asarray(x[:n_common]))
                              for x, _ in client_data]).to(dev)
        data_y = torch.stack([torch.as_tensor(np.asarray(y[:n_common]))
                              for _, y in client_data]).to(dev)
        k = len(params_list)
        bs = self.tcfg.batch_size
        nb = n_common // bs
        batches = {"x": data_x[:, :nb * bs].reshape(k, nb, bs, *data_x.shape[2:]),
                   "y": data_y[:, :nb * bs].reshape(k, nb, bs)}
        params = {n: v.to(dev) for n, v in _stack(params_list).items()}
        return data_x, data_y, batches, params, adam_init(params, clients=k)

    def _init_bucketed(self, buckets, params_list, client_data):
        """One ClientBucket (stacks and step) per stackable group, the
        shared relay commit, and the client id -> (bucket, slot) map."""
        self.spec = None
        self.buckets: List[ClientBucket] = []
        self._client_slot: Dict[int, Tuple[int, int]] = {}
        for b, (spec, ids) in enumerate(buckets):
            mine = self._local_ids[b]
            data_x, data_y, batches, params, opt = self._stack_clients(
                [params_list[i] for i in mine], [client_data[i] for i in mine],
                min(len(client_data[i][0]) for i in ids))
            self.buckets.append(ClientBucket(
                ids=np.asarray(mine, np.int64),
                whole=np.asarray(ids, np.int64),
                ids_t=torch.tensor(mine, dtype=torch.int32, device=self.device),
                params=params, opt=opt, batches=batches, data_x=data_x,
                data_y=data_y,
                step=make_bucket_update_step(
                    spec, self.ccfg, self.tcfg, self.policy,
                    per_client_payload=self._async, lagged=self._lagged),
                eval_hits=make_eval_hits(spec)))
            for j, i in enumerate(ids):
                self._client_slot[i] = (b, j)
        self._relay_commit = (
            make_async_relay_commit(self.policy, self._lagged, self.mesh,
                                    self._layout) if self._async
            else make_relay_commit(self.policy, self._lagged, self.mesh,
                                   self._layout, [n for _, n in self._spans]))
        # the ring advances in a synchronous round that commits nothing
        self._hist_push = history.push
        # no single step to put telemetry in: one call after the commit
        if self._telem:
            self._telem_fn = obs.metrics.make_telemetry_fn(
                self.n_clients, asynchronous=self._async, lagged=self._lagged)

    def client_params(self, i: int) -> Dict[str, torch.Tensor]:
        """Client i's parameters, unstacked: views into its stack where this
        rank holds client i. On a mesh, for a client of a client-sharded
        stack, this is a COLLECTIVE: every rank calls it with the same i
        and gets a copy from the rank that holds the client."""
        if self.hetero:
            b, j = self._client_slot[i]
            stack, n_mine = self.buckets[b].params, len(self.buckets[b].ids)
            n_all = len(self.buckets[b].whole)
        else:
            j, stack = i, self.params
            n_mine, n_all = self._hi - self._lo, self.n_clients
        if n_mine == n_all:
            return {k: v[j] for k, v in stack.items()}
        got = placement.gather({k: v[j % n_mine][None]
                                for k, v in stack.items()}, self.mesh)
        return {k: v[j // n_mine] for k, v in got.items()}

    # ------------------------------------------------------------------
    def _make_round_step(self):
        ccfg, N, mesh = self.ccfg, self.n_clients, self.mesh
        lagged, telem = self._lagged, self._telem
        bucket_step = make_bucket_update_step(self.spec, ccfg, self.tcfg,
                                              self.policy, lagged=lagged)
        commit = make_relay_commit(self.policy, mesh=mesh)
        compact = self._k_block < self._hi - self._lo

        def round_core(params, opt, rstate, batches, data_x, data_y, ids,
                       noise, picks, prio, mask, idx, *lag):
            # `lag` = (hist, dl) under a download clock: the snapshot ring
            # and this round's (N,) snapshot depths. On a mesh every
            # client-sharded input is this rank's block
            rstate0 = rstate
            # phase 0: the participants' (k, ...) block, gathered by `idx`
            full = (params, opt, batches, data_x, data_y, ids, noise, picks,
                    prio, mask) + lag[1:]
            if compact:
                full = tree_map(lambda a: a.index_select(0, idx), full)
            p_s, o_s, b_s, dx, dy, ids_s, noise_s, picks_s, prio_s, sub = \
                full[:10]
            # phases 1-3a: downlink from the round-start state (or each
            # client's snapshot), all local updates at once (Algorithm 2 x
            # k), absent clients frozen
            p_s, o_s, metrics, payload = bucket_step(
                p_s, o_s, lag[0] if lagged else rstate, b_s, dx, dy, ids_s,
                noise_s, picks_s, prio_s, sub, *full[10:])
            put = lambda whole, part: whole.index_copy(0, idx, part)
            if compact:
                metrics = {k: put(v.new_zeros(mask.shape + v.shape[1:]), v)
                           for k, v in metrics.items()}
            # phase 3b, the round's one exchange: one append and one merge,
            # kept only if someone took part; or fedavg's weight average;
            # the telemetry's per-client inputs ride along
            parts = None if not telem else _telemetry_parts(
                metrics, mask, dl=lag[1] if lagged else None)
            if payload is not None:
                rstate, parts = commit(rstate, [payload], extra=parts)
            elif ccfg.mode == "fedavg":
                p_s, parts = fedavg_average(p_s, sub, mesh, parts)
            elif parts is not None:
                parts = placement.exchange(parts, mesh)
            # phase 4: the block scattered back into the stacks
            if compact:
                params, opt = tree_map(put, params, p_s), tree_map(put, opt, o_s)
            else:
                params, opt = p_s, o_s
            # telemetry over the full-width metrics and mask: a synchronous
            # commit's lag is 0, so commit_hist is the participant count in
            # bin 0; stale reads come from the full-width delays
            tail = () if not telem else (
                _round_telemetry(rstate0, rstate, N, parts),)
            if lagged:
                # the ring advances every round, also when nothing
                # committed: "d rounds ago" counts rounds, not merges
                return (params, opt, rstate, history.push(lag[0], rstate),
                        metrics) + tail
            return (params, opt, rstate, metrics) + tail

        return round_core

    def _round_draws(self, r: int, ids, n: int):
        """This round's draws for clients `ids`, stacked and on the device:
        Gumbel noise (k, *policy.noise_shape), observation picks (k,),
        priorities (k, m_up, n); None outside cors and fd, which draw
        nothing."""
        ccfg, dev = self.ccfg, self.device
        m_down = max(1, ccfg.m_down)
        if ccfg.mode not in collab.RELAY_MODES:
            return None, None, None
        shape = self.policy.noise_shape(self.relay_state, m_down)
        teach = [self.draws.teacher(r, i, m_down, shape) for i in ids]
        noise = torch.stack([t[0] for t in teach]).to(dev)
        picks = torch.tensor([int(t[1]) for t in teach]).to(dev)
        prio = torch.stack([self.draws.priorities(r, i, ccfg.m_up, n)
                            for i in ids]).to(dev)
        return noise, picks, prio

    def _block_index(self, mask_mine) -> torch.Tensor:
        """The compacted block's rows of this rank's stack: its present
        clients, and on a mesh as many absent ones as pad the block to its
        fixed width (masked rows, which change nothing), ascending."""
        sel = np.nonzero(mask_mine)[0]
        if sel.size < self._k_block:
            pad = np.nonzero(~mask_mine)[0][:self._k_block - sel.size]
            sel = np.sort(np.concatenate([sel, pad]))
        return torch.as_tensor(sel).to(self.device)

    def _commits(self, r: int, mask_np, delays_np) -> List[Tuple[int, int]]:
        """The round's commits, [(birth round, client id)], in commit order:
        the event order of the commit mirror under asynchrony, the upload
        order's present clients in cors and fd, the present clients
        otherwise (the sequential engine's list)."""
        if self.ccfg.mode not in collab.RELAY_MODES:
            return [(r, int(i)) for i in np.nonzero(mask_np)[0]]
        if self._async:
            return self._commit_mirror.step(r, mask_np, delays_np,
                                            self._upload_order)
        return [(r, i) for i in self._upload_order if mask_np[i]]

    def run_round(self) -> Dict:
        ccfg, N, dev = self.ccfg, self.n_clients, self.device
        r = len(self.history)
        ids = self._ids if not self.hetero else None
        if self._cohort is not None:
            # the cohort's view: the mask over seats, each seat's external
            # id (the step's `ids` input: seat churn changes no shape) and
            # the owners evicted at admission, gone before any read
            view = self._cohort.round(r)
            mask_np = view.mask.copy()
            ids = _i32(view.seat_ids[self._lo:self._hi], dev)
            if view.evicted.size:
                with self._span("evict", round=r) as sp:
                    self.relay_state = self._evict(self.relay_state,
                                                   _i32(view.evicted, dev))
                    sp.block(self.relay_state)
        else:
            mask_np = np.asarray(self.schedule.mask(r, N), bool)
        present = np.nonzero(mask_np)[0]
        delays_np = (self.clock.delays(r, N) if self.clock is not None
                     else np.zeros((N,), np.int64))
        dl_np = self.dl_clock.delays(r, N) if self._lagged else None
        commits = self._commits(r, mask_np, delays_np)
        telem = None
        if self.hetero:
            metrics_parts, telem = self._run_buckets(r, mask_np, present,
                                                     delays_np, dl_np)
            model_size = 0
        else:
            mine = slice(self._lo, self._hi)
            noise, picks, prio = self._round_draws(
                r, range(self._lo, self._hi), self.data_y.shape[1])
            mask = torch.as_tensor(mask_np[mine]).to(dev)
            lag = ((self.hist, _i32(dl_np[mine], dev)) if self._lagged
                   else ())
            if self._async:
                with self._span("round_step", round=r) as sp:
                    out = sp.block(self._round_step(
                        self.params, self.opt_state, self.relay_state,
                        self.pending, self.batches, self.data_x,
                        self.data_y, ids, noise, picks, prio, mask,
                        _i32(delays_np[mine], dev), _i32(r, dev), *lag))
                if self._telem:
                    *out, telem = out
                self.params, self.opt_state, self.relay_state, self.pending \
                    = out[:4]
            else:
                if self._k_active < N:
                    if present.size != self._k_active:
                        raise ValueError(
                            f"schedule {self.schedule.name} emitted "
                            f"{present.size} participants, not its fixed_k "
                            f"{self._k_active}")
                if self._k_block < self._hi - self._lo:
                    idx = self._block_index(mask_np[mine])
                else:
                    idx = None                   # full width: no gather
                with self._span("round_step", round=r) as sp:
                    out = sp.block(self._round_step(
                        self.params, self.opt_state, self.relay_state,
                        self.batches, self.data_x, self.data_y, ids, noise,
                        picks, prio, mask, idx, *lag))
                if self._telem:
                    *out, telem = out
                self.params, self.opt_state, self.relay_state = out[:3]
            if self._lagged:
                self.hist = out[-2]
            metrics_parts = [out[-1]]
            model_size = self._model_size if ccfg.mode == "fedavg" else 0
        up, down = comm.round_floats(
            ccfg.mode, n_present=int(present.size), n_commit=len(commits),
            n_read=int(present.size) if self._lagged else None,
            C=ccfg.num_classes, d=ccfg.d_feature, m_up=ccfg.m_up,
            m_down=ccfg.m_down, model_size=model_size)
        self.ledger.log_round(up, down)
        with self._span("eval"):
            metrics_all, accs = self._records(metrics_parts)
        rec = collab.log_round(self.history, present, accs, metrics_all,
                               commits, up, down, telem)
        self._obs.emit(rec)
        return rec

    def _run_buckets(self, r: int, mask_np, present, delays_np,
                     dl_np) -> Tuple[List[Dict], object]:
        """One round across the buckets: every bucket's step reads the
        round-start relay state (or, under lag, the shared ring), then one
        commit exchanges and writes all uploads in bucket order and merges
        once. A synchronous round with no participant skips the commit on
        the host (the ring still advances); the asynchronous commit runs
        every round, with the mask and delays in upload order. -> (each
        bucket's metrics on this rank; the RoundTelemetry or None), the
        telemetry computed once after the commit from the exchanged losses
        and pending slots, with the mask and delays in client id order (its
        counts do not depend on the order)."""
        dev = self.device
        rstate0 = self.relay_state
        pending0 = self.pending if self._async else None
        payloads, parts = [], []
        with self._span("bucket_steps", round=r) as sp:
            for b in self.buckets:
                noise, picks, prio = self._round_draws(r, b.ids,
                                                       b.data_y.shape[1])
                b.params, b.opt, metrics, payload = b.step(
                    b.params, b.opt, self.hist if self._lagged else rstate0,
                    b.batches, b.data_x, b.data_y, b.ids_t, noise, picks,
                    prio, torch.as_tensor(mask_np[b.ids]).to(dev),
                    *((_i32(dl_np[b.ids], dev),) if self._lagged else ()))
                payloads.append(payload)
                parts.append(metrics)
            sp.block(parts)
        hist = (self.hist,) if self._lagged else ()
        # this rank's upload positions: the order of the pending buffer and
        # of the concatenated payloads
        order = self._local_order
        mask_up = torch.as_tensor(mask_np[order]).to(dev)
        delays_up = _i32(delays_np[order], dev) if self._async else None
        extra = None
        if self._telem:
            extra = _telemetry_parts(
                {k: torch.cat([m[k] for m in parts])
                 for k in ("total", "grad_norm")}, mask_up,
                pending=pending0, round_idx=_i32(r, dev), delays=delays_up)
        out = None
        with self._span("commit", round=r) as sp:
            if self._async:
                out = self._relay_commit(
                    rstate0, self.pending, payloads, _i32(r, dev), delays_up,
                    mask_up, *hist, extra=extra)
                self.relay_state, self.pending = out[:2]
            elif self.ccfg.mode in collab.RELAY_MODES and present.size:
                out = self._relay_commit(rstate0, payloads, *hist,
                                         extra=extra)
                self.relay_state = out[0]
            else:
                if self._lagged:
                    self.hist = self._hist_push(self.hist, rstate0)
                if extra is not None:
                    extra = placement.exchange(extra, self.mesh, self._layout)
            if out is not None:
                extra = out[-1]
                if self._lagged:
                    self.hist = out[-2]
            sp.block(self.relay_state)
        telem = None
        if self._telem:
            split = lambda v: tuple(v.narrow(0, a, n) for a, n in self._spans)
            rest = ()
            if self._async:
                pre, post = _pending_views(extra)
                rest = (pre, post, _i32(r, dev), _i32(delays_np, dev))
            rest += (_i32(dl_np, dev),) if self._lagged else ()
            telem = self._telem_fn(
                rstate0, self.relay_state, torch.as_tensor(mask_np).to(dev),
                split(extra["mask"]), split(extra["loss"]),
                split(extra["gnorm"]), *rest)
        return parts, telem

    def run(self, rounds: int, log_every: int = 0) -> List[Dict]:
        for k in range(rounds):
            rec = self.run_round()
            if log_every and (k + 1) % log_every == 0:
                print(f"  round {rec['round']:3d} acc {rec['acc_mean']:.4f}"
                      f" ±{rec['acc_std']:.4f}")
        return self.history

    # ------------------------------------------------------------------
    def _stacks(self):
        """(eval function, parameter stack, whole client ids) of each
        stack, in bucket order."""
        if not self.hetero:
            return [(self._eval_hits, self.params, np.arange(self.n_clients))]
        return [(b.eval_hits, b.params, b.whole) for b in self.buckets]

    def _records(self, metrics_parts=None, batch: int = 512):
        """Every client's test accuracy and, given each stack's (k,) metrics
        on this rank, its metrics, both by client id: all of a stack's
        clients on each test chunk in one call, the hit counts added on the
        device; on a mesh one gather of every stack's hits and metrics
        (outside the round step), then one host read a stack."""
        n = self.test_x.shape[0]
        local = []
        for j, (hits, P, _) in enumerate(self._stacks()):
            correct = 0
            for i in range(0, n, batch):
                correct = correct + hits(P, self.test_x[i:i + batch],
                                         self.test_y[i:i + batch])
            local.append({"hits": correct} if metrics_parts is None
                         else {"hits": correct, "m": metrics_parts[j]})
        if self.mesh is not None:
            whole = placement.gather(
                tree_map(lambda *xs: torch.cat(xs), *local), self.mesh,
                self._layout)
            local = [tree_map(lambda v: v.narrow(0, a, k), whole)
                     for a, k in self._spans]
        accs = np.zeros((self.n_clients,))
        metrics_all: List[Dict] = [None] * self.n_clients
        for part, (_, _, ids) in zip(local, self._stacks()):
            accs[ids] = part["hits"].cpu().numpy() / n
            if metrics_parts is not None:
                for j, m in enumerate(_host_metrics(part["m"])):
                    metrics_all[int(ids[j])] = m
        return metrics_all, accs.tolist()

    def evaluate_all(self, batch: int = 512) -> List[float]:
        """Per-client test accuracy by client id (on a mesh a collective:
        every rank gets every client's)."""
        return self._records(batch=batch)[1]


def _check_mesh(mesh, n_clients: int):
    """`FleetConfig.mesh` as the engine takes it: None, or a DeviceMesh
    with a "clients" axis whose size divides the fleet."""
    if mesh is None:
        return None
    names = getattr(mesh, "mesh_dim_names", None) or ()
    if placement.CLIENT_AXIS not in names:
        raise ValueError(
            f"FleetConfig.mesh must be a torch.distributed DeviceMesh with a "
            f"{placement.CLIENT_AXIS!r} axis (sharding.client_mesh); got "
            f"{mesh!r}")
    w = sharding.axis_size(mesh, placement.CLIENT_AXIS)
    if n_clients % w:
        raise ValueError(
            f"FleetConfig.mesh: the fleet's client axis (N={n_clients}) must "
            f"divide the mesh's {placement.CLIENT_AXIS!r} axis ({w} ranks). "
            "CLIENT_SHARDED state at rest (the client stacks, the async "
            "pending buffer) is held in equal contiguous blocks, one a rank "
            "(a mixed fleet's bucket that the mesh does not divide is held "
            "whole by every rank instead). Pad the fleet or use a rank "
            "count that divides it.")
    return mesh


def _stack_placement(mesh, n: int) -> str:
    """Where a stack of n clients lives on `mesh`: client-sharded when the
    mesh divides n (and off a mesh, where every stack is whole anyway),
    replicated otherwise."""
    if mesh is not None and n % sharding.axis_size(mesh,
                                                   placement.CLIENT_AXIS):
        return placement.REPLICATED
    return placement.CLIENT_SHARDED


def _held_whole(declaration, what: str):
    """The engine holds the relay state and its history ring whole on every
    rank, as their placement declarations say."""
    if placement.tags(declaration) != {placement.REPLICATED}:
        raise NotImplementedError(
            f"the {what}'s placement declaration has client-sharded leaves; "
            "the vectorized engine holds it whole on every rank")


def _i32(a, dev) -> torch.Tensor:
    """A host int or int array as an int32 tensor on `dev`, made before a
    step so that the step reads nothing back to the host."""
    return torch.as_tensor(np.asarray(a), dtype=torch.int32).to(dev)


def _host_metrics(metrics: Dict[str, torch.Tensor]) -> List[Dict]:
    """A stack's (k,) metrics, read in one host copy -> k dicts of floats."""
    keys = list(metrics)
    vals = torch.stack([metrics[k] for k in keys]).cpu().numpy()
    return [{k: float(vals[j, i]) for j, k in enumerate(keys)}
            for i in range(vals.shape[1])]
