"""Multi-client simulation trainer, the sequential engine; the port of
`repro/core/collab.py:CollabTrainer` for synchronous rounds.

It runs CoRS and the paper's Table 1 baselines with one data split,
optimizer and round accounting: modes `cors`, `fd` (federated
distillation), `fedavg`, `il` and `cl` (il on one client holding all the
data), with full participation and any relay policy of `relay/` (`flat`,
`per_class`, `staleness[:lam]`). Every round has the reference's phases:
  1. downlink: every client samples a teacher from the relay state of the
     PREVIOUS round (cors, fd);
  2. local updates (Algorithm 2), client by client;
  3. uplink: uploads in bucket order, then one merge (cors, fd); fedavg
     instead replaces every client's weights by their average.
Then the ledger is billed and every client is evaluated.

The reference draws its random numbers with `jax.random` from a per-round
key schedule. The port takes them from a `draws` object instead: Gumbel
noise of the policy's `noise_shape` and the observation pick for each
teacher, priorities for each upload's observation draw. `TorchDraws` (the
default) makes them from a seeded CPU `torch.Generator` per (round, client)
and moves them to the device, so a CUDA run and a CPU run of one seed draw
the same numbers; the parity tests pass draws made from the reference's
own keys.
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
from repro_torch.relay import base
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
    "participation": "participation schedules (ROADMAP slice 3)",
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
    if fleet.participation not in (None, "full"):
        raise NotImplementedError(
            f"participation {fleet.participation!r} comes with "
            f"{_FLEET_SLICES['participation']}")
    for f in ("clock", "download_clock", "arrivals", "mesh"):
        v = getattr(fleet, f)
        if v is not None and v != "none":
            raise NotImplementedError(
                f"FleetConfig.{f}={v!r} comes with {_FLEET_SLICES[f]}")
    return policy


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
        policy = check_setup(ccfg, fleet if fleet is not None else FleetConfig())
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

        # phase 1: downlink from the previous round's state
        teachers = []
        for i in range(N):
            if mode in RELAY_MODES:
                noise, pick = self.draws.teacher(
                    r, i, m_down, self.server.policy.noise_shape(
                        self.server.state, m_down))
                teachers.append(self.server.relay(i, m_down, noise, pick))
            else:
                teachers.append(client_lib.empty_teacher(ccfg, self.device))

        # phase 2: local updates (Algorithm 2)
        metrics_all = []
        for i, c in enumerate(self.clients):
            c.params, c.opt_state, m = self._updaters[i](
                c.params, c.opt_state, self._batches(c), teachers[i])
            metrics_all.append(m)

        # phase 3: uplink in bucket order, then one merge (Algorithm 1)
        commits = [(r, i) for i in range(N)]
        if mode in RELAY_MODES:
            self.server.begin_round()
            for i in self._upload_order:
                c = self.clients[i]
                prio = self.draws.priorities(r, i, ccfg.m_up,
                                             c.data_x.shape[0])
                payload = client_lib.compute_uploads(
                    c.spec, c.params, c.data_x, c.data_y, ccfg,
                    prio.to(self.device))
                self.server.upload(i, payload)
            self.server.end_round()
            commits = [(r, i) for i in self._upload_order]
        elif mode == "fedavg":
            # every client gets its own copy of the average (Adam's moments
            # are not averaged)
            avg = baselines.fedavg_aggregate([c.params for c in self.clients])
            for c in self.clients:
                c.params = {k: v.clone() for k, v in avg.items()}

        up, down = comm.round_floats(
            mode, n_present=N, n_commit=len(commits), C=ccfg.num_classes,
            d=ccfg.d_feature, m_up=ccfg.m_up, m_down=ccfg.m_down,
            model_size=(baselines.num_params(self.clients[0].params)
                        if mode == "fedavg" else 0))
        self.ledger.log_round(up, down)

        accs = [self.evaluate(c) for c in self.clients]
        rec = {"round": r + 1,
               "acc_mean": float(np.mean(accs)),
               "acc_std": float(np.std(accs)),
               "accs": accs,
               "metrics": [{k: float(v) for k, v in m.items()}
                           for m in metrics_all],
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
    @torch.no_grad()
    def evaluate(self, c: ClientState, batch: int = 512) -> float:
        n = self.test_x.shape[0]
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        for i in range(0, n, batch):
            _, lg = c.spec.apply(c.params, self.test_x[i:i + batch])
            correct += (lg.argmax(-1) == self.test_y[i:i + batch]).sum()
        return int(correct) / n
