"""Multi-client simulation trainer, the sequential engine; the port of
`repro/core/collab.py:CollabTrainer` for synchronous rounds.

It runs CoRS and the paper's Table 1 baselines with one data split,
optimizer and round accounting: modes `cors`, `fd` (federated
distillation), `fedavg`, `il` and `cl` (il on one client holding all the
data), under any relay policy of `relay/` (`flat`, `per_class`,
`staleness[:lam]`) and any participation schedule of
`relay/participation.py` (`full`, `uniform_k:K`, `cyclic:K`,
`bernoulli:P`, `adaptive:P[,BOOST]`). Clients may run different models
(cors, fd, il): they are grouped into buckets of one model
(`client.bucketize`), and uploads go in bucket order. Every round has the
reference's phases:
  1. downlink: every PRESENT client samples a teacher from the relay state
     of the PREVIOUS round (cors, fd);
  2. local updates (Algorithm 2), client by client; absent clients are
     frozen and report zero metrics;
  3. uplink: present clients upload in bucket order, then one merge (cors,
     fd; none when nobody uploaded); fedavg instead replaces every present
     client's weights by their average.
Then the ledger bills the present clients and every client is evaluated.

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

from repro_torch import relay as relay_lib
from repro_torch.core import baselines, client as client_lib, comm
from repro_torch.device import resolve_device
from repro_torch.optim import adam_init
from repro_torch.relay import base, participation
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


_FLEET_SLICES = {
    "clock": "asynchrony (ROADMAP slice 4)",
    "download_clock": "asynchrony (ROADMAP slice 4)",
    "arrivals": "population scale (ROADMAP slice 5)",
    "mesh": "multi-device (ROADMAP slice 9)",
}


RELAY_MODES = ("cors", "fd")     # the modes that go through the relay


def check_setup(ccfg: CollabConfig, fleet: FleetConfig) -> relay_lib.RelayPolicy:
    """Refuses what the port does not run yet, naming the ROADMAP slice that
    brings it, and an unknown mode; -> the fleet's relay policy."""
    if ccfg.mode not in client_lib.MODES:
        raise ValueError(f"unknown mode {ccfg.mode!r} (have "
                         f"{sorted(client_lib.MODES)})")
    policy = relay_lib.get_policy(fleet.policy)
    for f in ("clock", "download_clock", "arrivals", "mesh"):
        v = getattr(fleet, f)
        if v is not None and v != "none":
            raise NotImplementedError(
                f"FleetConfig.{f}={v!r} comes with {_FLEET_SLICES[f]}")
    return policy


def log_round(history: List[Dict], present, accs, metrics_all, commits, up,
              down) -> Dict:
    """Appends one round's record to `history`, in the schema both engines
    share with the reference's: the present clients' ids, every client's
    accuracy and metrics (zeros for an absent client), the commits as
    [birth round, client id] pairs in commit order and the round's floats
    on the wire."""
    rec = {"round": len(history) + 1,
           "acc_mean": float(np.mean(accs)),
           "acc_std": float(np.std(accs)),
           "accs": accs,
           "metrics": metrics_all,
           "participants": np.asarray(present).tolist(),
           "commits": [[b, i] for b, i in commits],
           "comm_up": up, "comm_down": down}
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
                 fleet: FleetConfig = None, draws=None, device=None):
        fleet = fleet if fleet is not None else FleetConfig()
        policy = check_setup(ccfg, fleet)
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
        self.server = RelayServer(ccfg, ccfg.d_feature, seed,
                                  n_clients=len(specs), device=dev,
                                  policy=policy)
        self.schedule = participation.get_schedule(fleet.participation,
                                                   seed=seed)
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
        mask = np.asarray(self.schedule.mask(r, N), bool)
        present = np.nonzero(mask)[0]

        # phase 1: downlink from the previous round's state, present
        # clients only
        teachers = {}
        for i in present:
            if mode in RELAY_MODES:
                noise, pick = self.draws.teacher(
                    r, i, m_down, self.server.policy.noise_shape(
                        self.server.state, m_down))
                teachers[i] = self.server.relay(i, m_down, noise, pick)
            else:
                teachers[i] = client_lib.empty_teacher(ccfg, self.device)

        # phase 2: local updates (Algorithm 2); absent clients are frozen
        metrics_all = [client_lib.zero_metrics(ccfg) for _ in range(N)]
        for i in present:
            c = self.clients[i]
            c.params, c.opt_state, m = self._updaters[i](
                c.params, c.opt_state, self._batches(c), teachers[i])
            metrics_all[i] = m

        # phase 3: uplink in bucket order, then one merge (Algorithm 1); a
        # round with no upload leaves the relay untouched
        commits = [(r, int(i)) for i in present]
        if mode in RELAY_MODES:
            commits = [(r, i) for i in self._upload_order if mask[i]]
            self.server.begin_round()
            for _, i in commits:
                c = self.clients[i]
                prio = self.draws.priorities(r, i, ccfg.m_up,
                                             c.data_x.shape[0])
                payload = client_lib.compute_uploads(
                    c.spec, c.params, c.data_x, c.data_y, ccfg,
                    prio.to(self.device))
                self.server.upload(i, payload)
            if commits:
                self.server.end_round()
        elif mode == "fedavg" and present.size:
            # every present client gets its own copy of the average of the
            # present clients (Adam's moments are not averaged)
            avg = baselines.fedavg_aggregate(
                [self.clients[i].params for i in present])
            for i in present:
                self.clients[i].params = {k: v.clone()
                                          for k, v in avg.items()}

        up, down = comm.round_floats(
            mode, n_present=int(present.size), n_commit=len(commits),
            C=ccfg.num_classes, d=ccfg.d_feature, m_up=ccfg.m_up,
            m_down=ccfg.m_down,
            model_size=(baselines.num_params(self.clients[0].params)
                        if mode == "fedavg" else 0))
        self.ledger.log_round(up, down)

        accs = [self.evaluate(c) for c in self.clients]
        metrics_all = [{k: float(v) for k, v in m.items()}
                       for m in metrics_all]
        return log_round(self.history, present, accs, metrics_all, commits,
                         up, down)

    def run(self, rounds: int, log_every: int = 0) -> List[Dict]:
        for k in range(rounds):
            rec = self.run_round()
            if log_every and (k + 1) % log_every == 0:
                print(f"  round {rec['round']:3d} acc {rec['acc_mean']:.4f}"
                      f" ±{rec['acc_std']:.4f}")
        return self.history

    # ------------------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, c: ClientState, batch: int = 512) -> float:
        n = self.test_x.shape[0]
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        for i in range(0, n, batch):
            _, lg = c.spec.apply(c.params, self.test_x[i:i + batch])
            correct += (lg.argmax(-1) == self.test_y[i:i + batch]).sum()
        return int(correct) / n
