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

This slice runs every mode of the sequential engine (cors, fd, fedavg, il,
cl), the relay policies flat, per_class and staleness, every participation
schedule and heterogeneous buckets. fedavg's weight average is part of the
round step, in float32, as the reference computes it. Asynchrony, download
lag, population arrivals, telemetry and the mesh raise
`NotImplementedError` naming the ROADMAP slice that brings them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import baselines, client as client_lib, collab, comm, \
    prototypes
from repro_torch.device import resolve_device
from repro_torch.optim import adam_init
from repro_torch.relay import participation
from repro_torch.relay.participation import freeze_absent, keep_if, tree_map
from repro_torch.types import CollabConfig, FleetConfig, TrainConfig


def _stack(trees: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


# ---------------------------------------------------------------------------
# Round-phase builders, as in the reference: the fused round step is composed
# of these.
# ---------------------------------------------------------------------------
def make_teacher_phase(policy, ccfg: CollabConfig):
    """Phase 1 (downlink): every client's teacher sampled from the relay in
    one batched draw of the policy (cors, fd), a broadcast no-op teacher
    otherwise. Returns `teachers(rstate, ids, noise, picks) -> teacher dict
    (k, ...)`."""
    m_down = max(1, ccfg.m_down)

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
    """Phase 3a (uplink, compute side): the per-client pieces reduced into
    one relay append. Returns `uploads_of(params, data_x, data_y, prio, ids,
    mask) -> dict(proto, logit (fd mode, else None), obs_rows, valid_rows,
    owner_rows, row_mask)`: absent clients' prototype and logit sums are
    zero-weighted and their observation rows masked out."""
    per_client = make_client_upload_phase(spec, ccfg)

    def uploads_of(p_s, dx, dy, prio, ids_s, sub_mask):
        wf = sub_mask.to(torch.float32)
        u = per_client(p_s, dx, dy, prio, ids_s)
        reduce = lambda s, c: prototypes.ProtoState(
            (s * wf[:, None, None]).sum(0), (c * wf[:, None]).sum(0))
        k, m_real = u["obs"].shape[:2]
        return {"proto": reduce(u["psum"], u["pcnt"]),
                "logit": (reduce(u["lsum"], u["lcnt"]) if "lsum" in u
                          else None),
                "obs_rows": u["obs"].reshape(k * m_real, *u["obs"].shape[2:]),
                "valid_rows": u["valid"][:, None].expand(k, m_real, -1)
                .reshape(k * m_real, -1),
                "owner_rows": u["owner"][:, None].expand(k, m_real).reshape(-1),
                "row_mask": sub_mask[:, None].expand(k, m_real).reshape(-1)}

    return uploads_of


def make_relay_commit(policy):
    """Phase 3b: the round's single relay write. `commit(rstate, payloads)`
    concatenates the payloads' observation rows (in upload order), appends
    them through the policy in one write and runs ONE merge of the
    prototype sums (and, in fd mode, the logit sums)."""

    def commit(rstate, payloads):
        cat = lambda k: torch.cat([p[k] for p in payloads])
        proto = prototypes.merge(*[p["proto"] for p in payloads])
        logit = (prototypes.merge(*[p["logit"] for p in payloads])
                 if payloads[0]["logit"] is not None else None)
        new = policy.append(rstate, cat("obs_rows"), cat("valid_rows"),
                            cat("owner_rows"), cat("row_mask"))
        return policy.merge_round(new, proto, logit)

    return commit


def fedavg_average(params, mask):
    """fedavg's exchange inside the round step: every present client's
    weights replaced by the float32 average over the present clients,
    sum(p . w) / n_present, as the reference's vectorized engine computes
    it; absent clients keep theirs. New tensors, none shared."""
    wf = mask.to(torch.float32)
    denom = wf.sum().clamp(min=1.0)

    def avg(p):
        b = (-1,) + (1,) * (p.dim() - 1)
        a = ((p.float() * wf.reshape(b)).sum(0) / denom).to(p.dtype)
        return torch.where(mask.reshape(b), a.expand_as(p), p)

    return {k: avg(v) for k, v in params.items()}


def make_bucket_update_step(spec: client_lib.ClientSpec, ccfg: CollabConfig,
                            tcfg: TrainConfig, policy):
    """Phases 1-3a of one stack of clients of one model, full-width and
    masked, against a FIXED relay state: downlink, local updates (absent
    clients' parameters and Adam state frozen, their metrics zeroed) and the
    upload payload. The relay write (3b) is not here, so that every bucket
    of a mixed fleet reads the same round-start state and one shared commit
    follows. Returns `step(params, opt, rstate, batches, data_x, data_y,
    ids, noise, picks, prio, mask) -> (params, opt, metrics, payload)`;
    `payload` is None outside cors and fd."""
    local_update = client_lib.make_local_update_fn(spec, ccfg, tcfg,
                                                   stacked=True)
    teachers = make_teacher_phase(policy, ccfg)
    uploads_of = make_upload_phase(spec, ccfg)

    def step(params, opt, rstate, batches, data_x, data_y, ids, noise,
             picks, prio, mask):
        teacher = teachers(rstate, ids, noise, picks)
        new_p, new_o, metrics = local_update(params, opt, batches, teacher)
        params = freeze_absent(mask, new_p, params)
        opt = freeze_absent(mask, new_o, opt)
        metrics = {k: torch.where(mask, v, 0.0) for k, v in metrics.items()}
        payload = (uploads_of(params, data_x, data_y, prio, ids, mask)
                   if ccfg.mode in collab.RELAY_MODES else None)
        return params, opt, metrics, payload

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
    and the bucket's step and eval. `ids` are the clients' ids (ascending),
    which tag their ring rows and pick their draws and mask entries."""
    ids: np.ndarray
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
    sequential engine."""

    def __init__(self, specs, params_list: Sequence[Dict[str, torch.Tensor]],
                 client_data: Sequence[Tuple], test_data: Tuple,
                 ccfg: CollabConfig, tcfg: TrainConfig, seed: int = 0,
                 fleet: FleetConfig = None, draws=None, device=None,
                 telemetry=None):
        fleet = fleet if fleet is not None else FleetConfig()
        self.policy = collab.check_setup(ccfg, fleet)
        if telemetry:
            raise NotImplementedError(
                "telemetry comes with observability and I/O (ROADMAP slice 6)")
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
        self.schedule = participation.get_schedule(fleet.participation,
                                                   seed=seed)
        self._upload_order = [i for _, ids in buckets for i in ids]
        self.relay_state = self.policy.init_state(ccfg, ccfg.d_feature, seed,
                                                  n_clients=N, device=dev)
        as_t = lambda a: torch.as_tensor(np.asarray(a)).to(dev)
        self.test_x, self.test_y = as_t(test_data[0]), as_t(test_data[1])
        self.draws = draws if draws is not None else collab.TorchDraws(seed)
        self.ledger = comm.CommLedger()
        self.history: List[Dict] = []
        if self.hetero:
            self._init_bucketed(buckets, params_list, client_data)
            return

        self.spec = buckets[0][0]
        self.data_x, self.data_y, self.batches, self.params, self.opt_state \
            = self._stack_clients(params_list, client_data)
        self._model_size = baselines.num_params(self.client_params(0))
        self._ids = torch.arange(N, dtype=torch.int32, device=dev)
        # static-k compaction: only when the schedule's participant count is
        # fixed and a strict subset (a full-size gather and scatter-back
        # would tax every full round for nothing)
        fixed_k = self.schedule.fixed_k
        self._k_active = fixed_k if fixed_k is not None else N
        self._round_step = self._make_round_step()
        self._eval_hits = make_eval_hits(self.spec)

    # ------------------------------------------------------------------
    def _stack_clients(self, params_list, client_data):
        """Trimmed data, batched views, parameters and fresh Adam state (one
        step count a client), all with a leading client axis, on the
        device."""
        dev = self.device
        n_common = min(len(x) for x, _ in client_data)
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
            data_x, data_y, batches, params, opt = self._stack_clients(
                [params_list[i] for i in ids], [client_data[i] for i in ids])
            self.buckets.append(ClientBucket(
                ids=np.asarray(ids, np.int64),
                ids_t=torch.tensor(ids, dtype=torch.int32, device=self.device),
                params=params, opt=opt, batches=batches, data_x=data_x,
                data_y=data_y,
                step=make_bucket_update_step(spec, self.ccfg, self.tcfg,
                                             self.policy),
                eval_hits=make_eval_hits(spec)))
            for j, i in enumerate(ids):
                self._client_slot[i] = (b, j)
        self._relay_commit = make_relay_commit(self.policy)

    def client_params(self, i: int) -> Dict[str, torch.Tensor]:
        """Client i's parameters, unstacked (views into its stack)."""
        if self.hetero:
            b, j = self._client_slot[i]
            return {k: v[j] for k, v in self.buckets[b].params.items()}
        return {k: v[i] for k, v in self.params.items()}

    # ------------------------------------------------------------------
    def _make_round_step(self):
        ccfg, N = self.ccfg, self.n_clients
        bucket_step = make_bucket_update_step(self.spec, ccfg, self.tcfg,
                                              self.policy)
        commit = make_relay_commit(self.policy)
        compact = self._k_active < N

        def round_core(params, opt, rstate, batches, data_x, data_y, ids,
                       noise, picks, prio, mask, idx):
            # phase 0: the participants' (k, ...) block, gathered by `idx`
            full = (params, opt, batches, data_x, data_y, ids, noise, picks,
                    prio, mask)
            if compact:
                full = tree_map(lambda a: a.index_select(0, idx), full)
            p_s, o_s, b_s, dx, dy, ids_s, noise_s, picks_s, prio_s, sub = full
            # phases 1-3a: downlink from the round-start state, all local
            # updates at once (Algorithm 2 x k), absent clients frozen
            p_s, o_s, metrics, payload = bucket_step(
                p_s, o_s, rstate, b_s, dx, dy, ids_s, noise_s, picks_s,
                prio_s, sub)
            # phase 3b: one append, one merge, kept only if someone took
            # part; or fedavg's weight average
            if payload is not None:
                rstate = keep_if(sub.any(), commit(rstate, [payload]), rstate)
            elif ccfg.mode == "fedavg":
                p_s = fedavg_average(p_s, sub)
            # phase 4: the block scattered back into the stacks
            if compact:
                put = lambda whole, part: whole.index_copy(0, idx, part)
                params, opt = tree_map(put, params, p_s), tree_map(put, opt, o_s)
                metrics = {k: put(v.new_zeros((N,) + v.shape[1:]), v)
                           for k, v in metrics.items()}
            else:
                params, opt = p_s, o_s
            return params, opt, rstate, metrics

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

    def _commits(self, r: int, mask_np) -> List[Tuple[int, int]]:
        """The round's commits, [(birth round, client id)], in commit order:
        the upload order's present clients in cors and fd, the present
        clients otherwise (the sequential engine's list)."""
        if self.ccfg.mode in collab.RELAY_MODES:
            return [(r, i) for i in self._upload_order if mask_np[i]]
        return [(r, int(i)) for i in np.nonzero(mask_np)[0]]

    def run_round(self) -> Dict:
        ccfg, N = self.ccfg, self.n_clients
        r = len(self.history)
        mask_np = np.asarray(self.schedule.mask(r, N), bool)
        present = np.nonzero(mask_np)[0]
        commits = self._commits(r, mask_np)
        if self.hetero:
            metrics_all = self._run_buckets(r, mask_np, present)
            model_size = 0
        else:
            if self._k_active < N:
                if present.size != self._k_active:
                    raise ValueError(
                        f"schedule {self.schedule.name} emitted "
                        f"{present.size} participants, not its fixed_k "
                        f"{self._k_active}")
                idx = torch.as_tensor(present).to(self.device)
            else:
                idx = None                       # full width: no gather
            noise, picks, prio = self._round_draws(r, range(N),
                                                   self.data_y.shape[1])
            self.params, self.opt_state, self.relay_state, metrics = \
                self._round_step(self.params, self.opt_state,
                                 self.relay_state, self.batches, self.data_x,
                                 self.data_y, self._ids, noise, picks, prio,
                                 torch.as_tensor(mask_np).to(self.device),
                                 idx)
            metrics_all = _host_metrics(metrics)
            model_size = self._model_size if ccfg.mode == "fedavg" else 0
        up, down = comm.round_floats(
            ccfg.mode, n_present=int(present.size), n_commit=len(commits),
            C=ccfg.num_classes, d=ccfg.d_feature, m_up=ccfg.m_up,
            m_down=ccfg.m_down, model_size=model_size)
        self.ledger.log_round(up, down)
        return collab.log_round(self.history, present, self.evaluate_all(),
                                metrics_all, commits, up, down)

    def _run_buckets(self, r: int, mask_np, present) -> List[Dict]:
        """One synchronous round across the buckets: every bucket's step
        reads the round-start relay state, then one commit writes all
        uploads in bucket order and merges once (skipped when nobody took
        part). -> every client's metrics, by client id."""
        rstate0 = self.relay_state
        payloads, parts = [], []
        for b in self.buckets:
            noise, picks, prio = self._round_draws(r, b.ids,
                                                   b.data_y.shape[1])
            b.params, b.opt, metrics, payload = b.step(
                b.params, b.opt, rstate0, b.batches, b.data_x, b.data_y,
                b.ids_t, noise, picks, prio,
                torch.as_tensor(mask_np[b.ids]).to(self.device))
            payloads.append(payload)
            parts.append(metrics)
        if self.ccfg.mode in collab.RELAY_MODES and present.size:
            self.relay_state = self._relay_commit(rstate0, payloads)
        metrics_all: List[Dict] = [None] * self.n_clients
        for b, metrics in zip(self.buckets, parts):
            for j, m in enumerate(_host_metrics(metrics)):
                metrics_all[int(b.ids[j])] = m
        return metrics_all

    def run(self, rounds: int, log_every: int = 0) -> List[Dict]:
        for k in range(rounds):
            rec = self.run_round()
            if log_every and (k + 1) % log_every == 0:
                print(f"  round {rec['round']:3d} acc {rec['acc_mean']:.4f}"
                      f" ±{rec['acc_std']:.4f}")
        return self.history

    # ------------------------------------------------------------------
    def evaluate_all(self, batch: int = 512) -> List[float]:
        """Per-client test accuracy: all of a stack's clients on each test
        chunk in one call, the hit counts added on the device, one host
        read a stack."""
        n = self.test_x.shape[0]

        def stack_hits(hits, P):
            correct = 0
            for i in range(0, n, batch):
                correct = correct + hits(P, self.test_x[i:i + batch],
                                         self.test_y[i:i + batch])
            return correct.cpu().numpy() / n

        if not self.hetero:
            return stack_hits(self._eval_hits, self.params).tolist()
        accs = np.zeros((self.n_clients,))
        for b in self.buckets:
            accs[b.ids] = stack_hits(b.eval_hits, b.params)
        return accs.tolist()


def _host_metrics(metrics: Dict[str, torch.Tensor]) -> List[Dict]:
    """A stack's (k,) metrics, read in one host copy -> k dicts of floats."""
    keys = list(metrics)
    vals = torch.stack([metrics[k] for k in keys]).cpu().numpy()
    return [{k: float(vals[j, i]) for j, k in enumerate(keys)}
            for i in range(vals.shape[1])]
