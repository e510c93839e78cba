"""Vectorized multi-client engine: all clients advance through ONE batched
round step; the port of `repro/core/vec_collab.py` for homogeneous,
synchronous fleets.

The sequential `CollabTrainer` steps clients in a Python loop: N dispatches
per phase, each a few small device operations. This engine stacks the
clients' parameters, Adam moments and data along a leading client axis and
runs the round (relay sampling, local updates, uploads, one relay write and
merge) on the stacks: the model under `torch.func.vmap` over the stacked
parameters, the losses with an explicit client axis, so that disc_loss's
forward and backward kernels are launched once a local step for the whole
fleet and proto_accum once a round. Given the same draws and equal-size
partitions the two engines evolve identical relay bookkeeping and weights
equal up to float32 summation order (tests/test_torch_vec_collab.py).

The round step never waits on the card: the draws of a round are stacked
and moved to the device before it, the relay's ring write has fixed shapes,
and the host reads the metrics and the accuracies once each, after it. It
is the counterpart of the reference's single jitted step
(`_round_step._cache_size() == 1`); capturing it in a CUDA graph is queued
in ROADMAP.

This slice runs the reference's homogeneous fused path with full
participation, every mode of the sequential engine (cors, fd, fedavg, il,
cl) and the relay policies flat, per_class and staleness. fedavg's weight
average is part of the round step, in float32, as the reference computes
it. Heterogeneous buckets, participation schedules and static-k
compaction, asynchrony, download lag, population arrivals, telemetry and
the mesh raise `NotImplementedError` naming the ROADMAP slice that brings
them.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import baselines, client as client_lib, collab, comm, \
    prototypes
from repro_torch.device import resolve_device
from repro_torch.optim import adam_init
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
    zero-weighted and their observation rows masked out (this slice runs
    full participation: the weights are ones)."""
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


def make_eval_hits(spec: client_lib.ClientSpec):
    """Stacked-client eval: logits of the whole client stack for one test
    chunk and the per-client hit counts (k,), on the device."""
    logits = torch.func.vmap(lambda p, x: spec.apply(p, x)[1], in_dims=(0, None))

    @torch.no_grad()
    def hits(P, x, y):
        return (logits(P, x).argmax(-1) == y[None]).sum(-1)

    return hits


class VectorizedCollabTrainer:
    """Counterpart of the sequential `CollabTrainer` for a homogeneous fleet:
    the same constructor (specs, parameters, data parts, test data, configs,
    seed, fleet, draws, device), `run_round` record schema, ledger and
    history. Client datasets are trimmed to the shortest partition so they
    stack; pass equal-size partitions for parity with the sequential
    engine."""

    def __init__(self, specs, params_list: Sequence[Dict[str, torch.Tensor]],
                 client_data: Sequence[Tuple], test_data: Tuple,
                 ccfg: CollabConfig, tcfg: TrainConfig, seed: int = 0,
                 fleet: FleetConfig = None, draws=None, device=None,
                 telemetry=None):
        self.policy = collab.check_setup(
            ccfg, fleet if fleet is not None else FleetConfig())
        if telemetry:
            raise NotImplementedError(
                "telemetry comes with observability and I/O (ROADMAP slice 6)")
        if isinstance(specs, client_lib.ClientSpec):
            specs = [specs] * len(params_list)
        if not len(specs) == len(params_list) == len(client_data):
            raise ValueError("one spec, parameter set and data part per client")
        buckets = client_lib.bucketize(specs, params_list)
        if len(buckets) > 1:
            raise NotImplementedError(
                f"{len(buckets)} client buckets: heterogeneous fleets come "
                "with relay breadth (ROADMAP slice 3)")
        self.device = dev = resolve_device(device)
        self.ccfg, self.tcfg = ccfg, tcfg
        self.n_clients = N = len(params_list)
        self.spec = buckets[0][0]
        self._upload_order = [i for _, ids in buckets for i in ids]
        self.relay_state = self.policy.init_state(ccfg, ccfg.d_feature, seed,
                                                  n_clients=N, device=dev)
        as_t = lambda a: torch.as_tensor(np.asarray(a)).to(dev)
        self.test_x, self.test_y = as_t(test_data[0]), as_t(test_data[1])
        self.draws = draws if draws is not None else collab.TorchDraws(seed)
        self.ledger = comm.CommLedger()
        self.history: List[Dict] = []
        self.data_x, self.data_y, self.batches, self.params, self.opt_state \
            = self._stack_clients(params_list, client_data)
        self._model_size = baselines.num_params(self.client_params(0))
        self._ids = torch.arange(N, dtype=torch.int32, device=dev)
        self._mask = torch.ones(N, dtype=torch.bool, device=dev)
        self._round_step = self._make_round_step()
        self._eval_hits = make_eval_hits(self.spec)

    # ------------------------------------------------------------------
    def _stack_clients(self, params_list, client_data):
        """Trimmed data, batched views, parameters and fresh Adam state, all
        with a leading client axis, on the device."""
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
        return data_x, data_y, batches, params, adam_init(params)

    def client_params(self, i: int) -> Dict[str, torch.Tensor]:
        """Client i's parameters, unstacked (views into the stack)."""
        return {k: v[i] for k, v in self.params.items()}

    # ------------------------------------------------------------------
    def _make_round_step(self):
        spec, ccfg = self.spec, self.ccfg
        local_update = client_lib.make_local_update_fn(spec, ccfg, self.tcfg,
                                                       stacked=True)
        teachers = make_teacher_phase(self.policy, ccfg)
        uploads_of = make_upload_phase(spec, ccfg)
        commit = make_relay_commit(self.policy)

        def round_core(params, opt, rstate, batches, data_x, data_y, ids,
                       noise, picks, prio, mask):
            # phase 1: downlink, every client from the round-start state
            teacher = teachers(rstate, ids, noise, picks)
            # phase 2: all local updates at once (Algorithm 2 x N)
            params, opt, metrics = local_update(params, opt, batches, teacher)
            # phase 3: uplink in upload order, one append, one merge; or
            # fedavg's weight average
            if ccfg.mode in collab.RELAY_MODES:
                rstate = commit(rstate, [uploads_of(params, data_x, data_y,
                                                    prio, ids, mask)])
            elif ccfg.mode == "fedavg":
                params = fedavg_average(params, mask)
            return params, opt, rstate, metrics

        return round_core

    def _round_draws(self, r: int):
        """This round's draws for all N clients, stacked and on the device:
        Gumbel noise (N, *policy.noise_shape), observation picks (N,),
        priorities (N, m_up, n); None outside cors and fd, which draw
        nothing."""
        ccfg, N, dev = self.ccfg, self.n_clients, self.device
        m_down = max(1, ccfg.m_down)
        if ccfg.mode not in collab.RELAY_MODES:
            return None, None, None
        shape = self.policy.noise_shape(self.relay_state, m_down)
        teach = [self.draws.teacher(r, i, m_down, shape) for i in range(N)]
        noise = torch.stack([t[0] for t in teach]).to(dev)
        picks = torch.tensor([int(t[1]) for t in teach]).to(dev)
        prio = torch.stack([self.draws.priorities(r, i, ccfg.m_up,
                                                  self.data_y.shape[1])
                            for i in range(N)]).to(dev)
        return noise, picks, prio

    def run_round(self) -> Dict:
        ccfg, N = self.ccfg, self.n_clients
        mode = ccfg.mode
        r = len(self.history)
        noise, picks, prio = self._round_draws(r)
        self.params, self.opt_state, self.relay_state, metrics = \
            self._round_step(self.params, self.opt_state, self.relay_state,
                             self.batches, self.data_x, self.data_y,
                             self._ids, noise, picks, prio, self._mask)
        commits = ([(r, i) for i in self._upload_order]
                   if mode in collab.RELAY_MODES
                   else [(r, i) for i in range(N)])
        up, down = comm.round_floats(
            mode, n_present=N, n_commit=len(commits), C=ccfg.num_classes,
            d=ccfg.d_feature, m_up=ccfg.m_up, m_down=ccfg.m_down,
            model_size=self._model_size if mode == "fedavg" else 0)
        self.ledger.log_round(up, down)

        keys = list(metrics)
        vals = torch.stack([metrics[k] for k in keys]).cpu().numpy()
        accs = self.evaluate_all()
        rec = {"round": r + 1,
               "acc_mean": float(np.mean(accs)),
               "acc_std": float(np.std(accs)),
               "accs": accs,
               "metrics": [{k: float(vals[j, i]) for j, k in enumerate(keys)}
                           for i in range(N)],
               "participants": list(range(N)),
               "commits": [[b, i] for b, i in commits],
               "comm_up": up, "comm_down": down}
        self.history.append(rec)
        return rec

    def run(self, rounds: int, log_every: int = 0) -> List[Dict]:
        for k in range(rounds):
            rec = self.run_round()
            if log_every and (k + 1) % log_every == 0:
                print(f"  round {rec['round']:3d} acc {rec['acc_mean']:.4f}"
                      f" ±{rec['acc_std']:.4f}")
        return self.history

    # ------------------------------------------------------------------
    def evaluate_all(self, batch: int = 512) -> List[float]:
        """Per-client test accuracy: all clients on each test chunk in one
        stacked call, the hit counts added on the device, one host read."""
        n = self.test_x.shape[0]
        correct = torch.zeros(self.n_clients, dtype=torch.int64,
                              device=self.device)
        for i in range(0, n, batch):
            correct += self._eval_hits(self.params, self.test_x[i:i + batch],
                                       self.test_y[i:i + batch])
        return (correct.cpu().numpy() / n).tolist()
