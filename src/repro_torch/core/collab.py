"""Multi-client simulation trainer, the sequential engine; the port of
`repro/core/collab.py:CollabTrainer`.

It runs CoRS and the paper's Table 1 baselines with one data split,
optimizer and round accounting: modes `cors`, `fd` (federated
distillation), `fedavg`, `il` and `cl` (il on one client holding all the
data), under any relay policy of `relay/` (`flat`, `per_class`,
`staleness[:lam]`, `sharded:<inner>,<S>[,<gossip_every>]`) and any
participation schedule of `relay/participation.py` (`full`,
`uniform_k:K`, `cyclic:K`, `bernoulli:P`, `adaptive:P[,BOOST]`). Clients
may run different models (cors, fd, il): they are grouped into buckets of
one model (`client.bucketize`), and uploads go in bucket order. Every
round has the reference's phases:
  1. downlink: every PRESENT client samples a teacher from the relay state
     of the PREVIOUS round, or under a download clock from the snapshot
     d(client, round) rounds staler (cors, fd);
  2. local updates (Algorithm 2), client by client; absent clients are
     frozen and report zero metrics;
  3. uplink: present clients' uploads enter the event queue in bucket
     order with their commit delay, then the round's due events commit in
     event order and one merge follows (cors, fd; none when nothing
     committed); fedavg instead replaces every present client's weights by
     their average.
Then the ledger bills uplink at commit and downlink at read, and every
client is evaluated.

Asynchrony: with `FleetConfig.clock` (a `repro_torch.sim` clock spec, e.g.
"lognormal:2") an upload born in round r with commit delay d is appended
in round r + d, stamped with its birth clock, in event order (birth round,
then upload position; `relay/events.py`). This engine replays that order
one host-side event at a time, the reference for the vectorized engine's
pending buffer. Teachers come from committed state only: uploads in
flight are invisible. With `FleetConfig.download_clock` a round-t client
reads the post-merge state of round t - d - 1 from `_snaps`, the
most-recent-first list of the last H_max = d_max + 1 states, the replay of
the vectorized engine's ring (`relay/history.py`). No clock, or d_max = 0,
is the synchronous fleet, bit for bit.

Population scale: with `FleetConfig.arrivals` ("stream:k,rate,p_leave,
population,seed", `sim/population.py`) the clients are SEATS of a bounded
cohort table: its round view says who takes part (k active seats), which
external id each seat holds and which owners it LRU-evicted to admit
newcomers. The evicted owners' ring slots are invalidated at round start,
before any read; ring rows carry the external id, draws stay keyed by
seat, and a reclaimed seat keeps its predecessor's weights and Adam state,
as in the reference. Arrivals refuse a participation schedule, an upload
clock with D_max > 0, a download clock, a mode without a relay and a
mixed fleet (`check_arrivals`). The sharded relay (`relay/shards.py`)
needs nothing of the engine but the owners of a round's uploads, which
`RelayServer` records for its per-shard reduction.

Telemetry (`telemetry=`, `repro_torch.obs`): each round record gains the
round's `RoundTelemetry`, the same function the vectorized engine computes
in its step, over this engine's ring, with the lags of the round's commits,
the queue depth and the download delays counted on the host; the phases
run in trace spans (evict, teacher_read, update, upload, commit, eval), the
record goes to the JSONL sink and the trace is rewritten after every round
(`RunObserver`).

The reference draws its random numbers with `jax.random` from a per-round
key schedule. The port takes them from a `draws` object instead: Gumbel
noise of the policy's `noise_shape` and the observation pick for each
teacher, priorities for each upload's observation draw. `TorchDraws` (the
default) makes them from a seeded CPU `torch.Generator` per (round, client)
and moves them to the device, so a CUDA run and a CPU run of one seed draw
the same numbers; the parity tests pass draws made from the reference's
own keys. Draws are indexed by client id, so an absent client's draws go
unused and change no other client's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs, relay as relay_lib, sim
from repro_torch.core import baselines, client as client_lib, comm
from repro_torch.device import resolve_device
from repro_torch.optim import adam_init
from repro_torch.relay import base, events, participation
from repro_torch.relay.server import RelayServer
from repro_torch.types import CollabConfig, FleetConfig, TrainConfig


class TorchDraws:
    """Seeded draws for the trainer: one CPU generator per (round, client,
    kind), so the numbers depend on nothing but the seed and the index."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)

    def _gen(self, r: int, i: int, kind: int) -> torch.Generator:
        seq = np.random.SeedSequence([self.seed, r, i, kind])
        return torch.Generator().manual_seed(int(seq.generate_state(1)[0]))

    def teacher(self, r: int, i: int, m_down: int, shape: tuple):
        """-> (Gumbel noise of `shape` (the policy's `noise_shape`) f32 on
        the CPU, obs_pick int)."""
        g = self._gen(r, i, 0)
        noise = base.gumbel(shape, g)
        pick = int(torch.randint(0, m_down, (), generator=g))
        return noise, pick

    def priorities(self, r: int, i: int, m_up: int, n: int):
        """-> observation priorities (m_up, n) f32 on the CPU."""
        return torch.rand(m_up, n, generator=self._gen(r, i, 1))


RELAY_MODES = ("cors", "fd")     # the modes that go through the relay


def check_setup(ccfg: CollabConfig, fleet: FleetConfig) -> relay_lib.RelayPolicy:
    """Refuses an unknown mode; -> the fleet's relay policy."""
    if ccfg.mode not in client_lib.MODES:
        raise ValueError(f"unknown mode {ccfg.mode!r} (have "
                         f"{sorted(client_lib.MODES)})")
    return relay_lib.get_policy(fleet.policy)


def check_arrivals(ccfg: CollabConfig, fleet: FleetConfig, clock,
                   n_buckets: int):
    """The fleet's arrival schedule (`sim.get_arrivals`), or None. A
    streaming fleet's cohort table owns participation, tags ring rows with
    external ids and evicts owners; the reference refuses five compositions
    with it, and so does the port, in its words: the pending buffer and the
    history ring key state by a static id space that seat turnover
    invalidates."""
    arrivals = sim.get_arrivals(fleet.arrivals)
    if arrivals is None:
        return None
    if fleet.participation is not None:
        raise ValueError(
            "streaming arrivals own participation (the cohort table picks "
            "k active seats per round); leave FleetConfig.participation "
            "unset")
    if clock is not None and clock.d_max > 0:
        raise ValueError(
            "streaming arrivals do not compose with an async upload clock "
            "yet: the pending buffer is indexed by upload position, which "
            "seat turnover reuses")
    if fleet.download_clock is not None:
        raise ValueError(
            "streaming arrivals do not compose with download lag yet: "
            "history snapshots hold evicted owners' rows")
    if ccfg.mode not in RELAY_MODES:
        raise ValueError(
            "streaming arrivals need a relay mode (cors | fd); "
            f"mode={ccfg.mode!r} has no server to stream through")
    if n_buckets > 1:
        raise ValueError(
            "streaming arrivals currently require a homogeneous fleet "
            f"(seats are interchangeable); got {n_buckets} client buckets")
    return arrivals


class RunObserver:
    """The engines' telemetry plumbing (`repro_torch.obs`), from their
    `telemetry=` argument: `config` (None when off), `metrics` (compute the
    RoundTelemetry), `span` (a trace span factory, a no-op without a
    recorder) and `emit(rec)`, which streams a round record to the JSONL
    sink and rewrites the trace after every round."""

    def __init__(self, telemetry):
        cfg = self.config = obs.resolve(telemetry)
        self.metrics = cfg is not None and cfg.metrics
        self.sink = obs.JsonlWriter(cfg.jsonl) if cfg and cfg.jsonl else None
        self.tracer = (obs.TraceRecorder(path=cfg.trace, profile=cfg.profile)
                       if cfg and (cfg.trace or cfg.profile) else None)
        self.span = self.tracer.span if self.tracer else obs.null_span

    def emit(self, rec: Dict):
        if self.sink is not None:
            self.sink.write(rec)
        if self.tracer is not None and self.config.trace:
            self.tracer.write()


def log_round(history: List[Dict], present, accs, metrics_all, commits, up,
              down, telemetry=None) -> Dict:
    """Appends one round's record to `history`, in the schema both engines
    share with the reference's: the present clients' ids, every client's
    accuracy and metrics (zeros for an absent client), the commits as
    [birth round, client id] pairs in commit order, the round's floats on
    the wire and, given a RoundTelemetry, its host form."""
    rec = {"round": len(history) + 1,
           "acc_mean": float(np.mean(accs)),
           "acc_std": float(np.std(accs)),
           "accs": accs,
           "metrics": metrics_all,
           "participants": np.asarray(present).tolist(),
           "commits": [[b, i] for b, i in commits],
           "comm_up": up, "comm_down": down}
    if telemetry is not None:
        rec["telemetry"] = obs.to_record(telemetry)
    history.append(rec)
    return rec


@dataclass
class ClientState:
    spec: client_lib.ClientSpec
    params: Dict[str, torch.Tensor]
    opt_state: Any
    data_x: torch.Tensor
    data_y: torch.Tensor


class CollabTrainer:
    def __init__(self, specs: Sequence[client_lib.ClientSpec],
                 params_list: Sequence[Dict[str, torch.Tensor]],
                 client_data: Sequence[Tuple[Any, Any]],
                 test_data: Tuple[Any, Any],
                 ccfg: CollabConfig, tcfg: TrainConfig, seed: int = 0,
                 fleet: FleetConfig = None, draws=None, device=None,
                 telemetry=None):
        fleet = fleet if fleet is not None else FleetConfig()
        policy = check_setup(ccfg, fleet)
        if fleet.mesh is not None:
            raise ValueError(
                "the sequential oracle steps clients host-side and holds "
                "no stacked client axis to shard; FleetConfig.mesh only "
                "applies to the vectorized engine (core/vec_collab.py)")
        # telemetry: the same RoundTelemetry function as the vectorized
        # engine's, over this engine's equal ring, with the event-log
        # quantities counted here on the host
        self._obs = RunObserver(telemetry)
        self.telemetry, self._span = self._obs.config, self._obs.span
        if not len(specs) == len(params_list) == len(client_data):
            raise ValueError("one spec, parameter set and data part per client")
        self.device = resolve_device(device)
        dev = self.device
        as_t = lambda a: torch.as_tensor(np.asarray(a)).to(dev)
        self.ccfg, self.tcfg = ccfg, tcfg
        self.clients = [
            ClientState(spec=s, params={k: v.to(dev) for k, v in p.items()},
                        opt_state=None, data_x=as_t(x), data_y=as_t(y))
            for s, p, (x, y) in zip(specs, params_list, client_data)]
        for c in self.clients:
            c.opt_state = adam_init(c.params)
        self.test_x, self.test_y = as_t(test_data[0]), as_t(test_data[1])
        buckets = client_lib.bucketize(specs, params_list)
        if ccfg.mode == "fedavg" and len(buckets) > 1:
            raise ValueError("fedavg averages weights: it needs one model "
                             "for every client")
        self._upload_order = [i for _, ids in buckets for i in ids]
        self._bucket_ids = [np.asarray(ids, np.int64) for _, ids in buckets]
        self._telem_fn = (obs.metrics.make_host_telemetry_fn(len(specs))
                          if self._obs.metrics else None)
        self.server = RelayServer(ccfg, ccfg.d_feature, seed,
                                  n_clients=len(specs), device=dev,
                                  policy=policy)
        self.clock = sim.get_clock(fleet.clock, seed=seed)
        self._queue = events.HostEventQueue()
        # a streaming fleet: the cohort table of len(specs) seats owns
        # participation, and its LRU evictions hit the relay at round start
        self.arrivals = check_arrivals(ccfg, fleet, self.clock, len(buckets))
        self._cohort = (self.arrivals.table(len(specs))
                        if self.arrivals is not None else None)
        self.schedule = (None if self._cohort is not None else
                         participation.get_schedule(fleet.participation,
                                                    seed=seed,
                                                    clock=self.clock))
        # download lag: `_snaps`, the last H_max post-merge relay states,
        # most recent first; only the relay modes download
        self.dl_clock = sim.get_download_clock(fleet.download_clock, seed=seed)
        self._lagged = (self.dl_clock is not None
                        and ccfg.mode in RELAY_MODES)
        self._h_max = (self.dl_clock.d_max + 1) if self._lagged else 1
        self._snaps = [self.server.state] if self._lagged else None
        self.draws = draws if draws is not None else TorchDraws(seed)
        self.ledger = comm.CommLedger()
        self._updaters = [client_lib.make_local_update_fn(c.spec, ccfg, tcfg)
                          for c in self.clients]
        self.history: List[Dict] = []

    # ------------------------------------------------------------------
    def _batches(self, c: ClientState):
        """Drops the remainder, as the reference does."""
        bs = self.tcfg.batch_size
        n = (c.data_x.shape[0] // bs) * bs
        return {"x": c.data_x[:n].reshape(-1, bs, *c.data_x.shape[1:]),
                "y": c.data_y[:n].reshape(-1, bs)}

    def run_round(self) -> Dict:
        ccfg = self.ccfg
        mode = ccfg.mode
        N = len(self.clients)
        r = len(self.history)
        m_down = max(1, ccfg.m_down)
        if self._cohort is not None:
            # the cohort's view: a mask over SEATS, the external id of each
            # seat, and the owners LRU-evicted at admission, whose ring slots
            # go before any read this round
            view = self._cohort.round(r)
            mask = view.mask.copy()
            ext_ids = view.seat_ids
            if view.evicted.size:
                with self._span("evict", round=r) as sp:
                    self.server.state = self.server.policy.evict_owners(
                        self.server.state, torch.as_tensor(
                            view.evicted, dtype=torch.int32).to(self.device))
                    sp.block(self.server.state)
        else:
            mask = np.asarray(self.schedule.mask(r, N), bool)
            ext_ids = None
        present = np.nonzero(mask)[0]
        # ring rows carry the EXTERNAL id of a streaming seat; a static
        # fleet's seat index is its id. Draws stay keyed by seat.
        owner_of = ((lambda i: int(ext_ids[i])) if ext_ids is not None
                    else int)

        delays = (self.clock.delays(r, N) if self.clock is not None
                  else np.zeros((N,), np.int64))
        dl = (self.dl_clock.delays(r, N) if self._lagged
              else np.zeros((N,), np.int64))

        # phase 1: downlink from the previous round's state, or from the
        # snapshot dl[i] rounds before it; present clients only
        prev_state = self.server.state
        teachers = {}
        with self._span("teacher_read", round=r) as sp:
            for i in present:
                if mode in RELAY_MODES:
                    noise, pick = self.draws.teacher(
                        r, i, m_down, self.server.policy.noise_shape(
                            self.server.state, m_down))
                    teachers[i] = self.server.relay(
                        owner_of(i), m_down, noise, pick,
                        state=self._snapshot(int(dl[i])))
                else:
                    teachers[i] = client_lib.empty_teacher(ccfg, self.device)
            sp.block(teachers)

        # phase 2: local updates (Algorithm 2); absent clients are frozen
        metrics_all = [client_lib.zero_metrics(ccfg) for _ in range(N)]
        with self._span("update", round=r) as sp:
            for i in present:
                c = self.clients[i]
                c.params, c.opt_state, m = self._updaters[i](
                    c.params, c.opt_state, self._batches(c), teachers[i])
                metrics_all[i] = m
            sp.block([c.params for c in self.clients])

        # phase 3: present clients' uploads enter the event queue in bucket
        # order with their commit delay and birth stamp; the round's due
        # events commit in event order, then one merge (Algorithm 1). A
        # round with no commit leaves the relay untouched.
        commits = [(r, int(i)) for i in present]
        if mode in RELAY_MODES:
            stamps = self.server.policy.host_stamps(
                self.server.state, [owner_of(i) for i in self._upload_order])
            with self._span("upload", round=r):
                for pos, i in enumerate(self._upload_order):
                    if not mask[i]:
                        continue
                    c = self.clients[i]
                    prio = self.draws.priorities(r, i, ccfg.m_up,
                                                 c.data_x.shape[0])
                    payload = client_lib.compute_uploads(
                        c.spec, c.params, c.data_x, c.data_y, ccfg,
                        prio.to(self.device))
                    self._queue.push(birth=r, pos=pos, client_id=i,
                                     stamp=int(stamps[pos]), payload=payload,
                                     delay=int(delays[i]))
            with self._span("commit", round=r) as sp:
                due = self._queue.pop_due(r)
                self.server.begin_round()
                for _, _, i, stamp, payload, _ in due:
                    # a streaming fleet is synchronous: every due event was
                    # pushed this round, under this round's seat ids
                    self.server.upload(owner_of(i), payload, stamp=stamp)
                if due:
                    self.server.end_round()
                sp.block(self.server.state)
            commits = [(birth, i) for birth, _, i, *_ in due]
        elif mode == "fedavg" and present.size:
            # every present client gets its own copy of the average of the
            # present clients (Adam's moments are not averaged)
            avg = baselines.fedavg_aggregate(
                [self.clients[i].params for i in present])
            for i in present:
                self.clients[i].params = {k: v.clone()
                                          for k, v in avg.items()}

        # the ring of snapshots advances every round, also when nothing
        # committed: "d rounds ago" counts rounds, not merges
        if self._lagged:
            self._snaps.insert(0, self.server.state)
            del self._snaps[self._h_max:]

        up, down = comm.round_floats(
            mode, n_present=int(present.size), n_commit=len(commits),
            n_read=int(present.size) if self._lagged else None,
            C=ccfg.num_classes, d=ccfg.d_feature, m_up=ccfg.m_up,
            m_down=ccfg.m_down,
            model_size=(baselines.num_params(self.clients[0].params)
                        if mode == "fedavg" else 0))
        self.ledger.log_round(up, down)

        with self._span("eval", round=r):
            accs = [self.evaluate(c) for c in self.clients]
        metrics_all = [{k: float(v) for k, v in m.items()}
                       for m in metrics_all]
        telem = (self._telemetry(r, prev_state, mask, metrics_all, commits,
                                 dl) if self._telem_fn is not None else None)
        rec = log_round(self.history, present, accs, metrics_all, commits,
                        up, down, telem)
        self._obs.emit(rec)
        return rec

    def _telemetry(self, r: int, prev_state, mask, metrics_all, commits, dl):
        """This round's RoundTelemetry: the relay reductions over the ring,
        with the lags of this round's commits (commit round - birth round,
        clipped into the last bin), the uploads still queued and the
        download delays, counted here on the host."""
        chist = np.zeros((obs.STALE_BINS,), np.int32)
        for birth, _ in commits:
            chist[min(r - birth, obs.STALE_BINS - 1)] += 1
        dev = self.device
        t = lambda a, dtype: torch.as_tensor(np.asarray(a), dtype=dtype).to(dev)
        parts = lambda key: tuple(
            t([metrics_all[i][key] for i in ids], torch.float32)
            for ids in self._bucket_ids)
        return self._telem_fn(
            prev_state, self.server.state, t(mask, torch.bool),
            tuple(t(mask[ids], torch.bool) for ids in self._bucket_ids),
            parts("total"), parts("grad_norm"), t(chist, torch.int32),
            t(len(self._queue), torch.int32), t(dl, torch.int32))

    def run(self, rounds: int, log_every: int = 0) -> List[Dict]:
        for k in range(rounds):
            rec = self.run_round()
            if log_every and (k + 1) % log_every == 0:
                print(f"  round {rec['round']:3d} acc {rec['acc_mean']:.4f}"
                      f" ±{rec['acc_std']:.4f}")
        return self.history

    def _snapshot(self, d: int):
        """The relay state as of `d` rounds ago (None, the live state, when
        no download clock is bound), clamped to the ring's depth; entries
        past the pushes made so far are the init state, as the vectorized
        ring's never-written slots are."""
        if not self._lagged:
            return None
        return self._snaps[min(d, self._h_max - 1, len(self._snaps) - 1)]

    # ------------------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, c: ClientState, batch: int = 512) -> float:
        n = self.test_x.shape[0]
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        for i in range(0, n, batch):
            _, lg = c.spec.apply(c.params, self.test_x[i:i + batch])
            correct += (lg.argmax(-1) == self.test_y[i:i + batch]).sum()
        return int(correct) / n
