"""ParticipationSchedule — which clients take part in each round; the port of
`repro/relay/participation.py`.

A schedule is a deterministic host-side function `mask(round_idx,
n_clients) -> (N,) bool` that both engines consume: the sequential engine
skips absent clients, the vectorized engine masks (or compacts) its stacked
client axis. The masks are drawn with numpy exactly as the reference draws
them, so a mask equals the reference's element for element for every spec,
seed and round.

`fixed_k` tells the vectorized engine whether the per-round participant
count is a static number: when it is (uniform_k, cyclic), the engine gathers
the k participants into a compact (k, ...) block and runs the round on it;
variable-count schedules (bernoulli, adaptive) return None and run
full-width with masking.

Semantics shared by both engines:
  - absent clients neither download, update nor upload; their parameters
    and Adam state are frozen for the round, bit for bit;
  - the prototype merge averages over PRESENT clients only;
  - the comm ledger bills only present clients;
  - a round with zero participants leaves the relay state untouched (no
    merge, no ageing).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.relay import events
from repro_torch.specs import parse_spec
from repro_torch.tree import tree_map


def bcast_mask(vec, like):
    """Broadcast a (k,) mask or weight vector against a (k, ...) leaf."""
    return vec.reshape(vec.shape + (1,) * (like.dim() - 1))


def freeze_absent(mask, new_tree, old_tree):
    """THE masking semantics of partial participation, in one place:
    present clients (mask True) take the freshly computed leaves, absent
    clients keep their old ones bit for bit. Leading axis = clients."""
    return tree_map(lambda n, o: torch.where(bcast_mask(mask, n), n, o),
                    new_tree, old_tree)


def keep_if(flag, new_tree, old_tree):
    """`new_tree` where the 0-d bool tensor `flag` holds, else `old_tree`,
    leaf by leaf on the device (no host read of `flag`)."""
    return tree_map(lambda n, o: torch.where(flag, n, o), new_tree, old_tree)


class ParticipationSchedule:
    name: str = "abstract"

    @property
    def fixed_k(self) -> Optional[int]:
        """Static per-round participant count, or None when it varies."""
        return None

    def mask(self, round_idx: int, n_clients: int) -> np.ndarray:
        raise NotImplementedError


@dataclass(frozen=True)
class FullParticipation(ParticipationSchedule):
    """Every client, every round."""
    name: str = "full"

    def mask(self, round_idx: int, n_clients: int) -> np.ndarray:
        return np.ones((n_clients,), bool)


@dataclass(frozen=True)
class UniformK(ParticipationSchedule):
    """k clients drawn uniformly without replacement each round (the
    FedAvg paper's "random fraction" schedule)."""
    k: int
    seed: int = 0
    name: str = "uniform_k"

    @property
    def fixed_k(self) -> Optional[int]:
        return self.k

    def mask(self, round_idx: int, n_clients: int) -> np.ndarray:
        if not 0 < self.k <= n_clients:
            raise ValueError(f"uniform_k:{self.k} needs 0 < k <= "
                             f"{n_clients} clients")
        rng = np.random.default_rng([self.seed, round_idx])
        m = np.zeros((n_clients,), bool)
        m[rng.choice(n_clients, self.k, replace=False)] = True
        return m


@dataclass(frozen=True)
class Cyclic(ParticipationSchedule):
    """Deterministic round-robin: round r serves clients
    {(r k + i) mod N : i < k} (the duty-cycle schedule)."""
    k: int
    name: str = "cyclic"

    @property
    def fixed_k(self) -> Optional[int]:
        return self.k

    def mask(self, round_idx: int, n_clients: int) -> np.ndarray:
        if not 0 < self.k <= n_clients:
            raise ValueError(f"cyclic:{self.k} needs 0 < k <= {n_clients} "
                             f"clients")
        m = np.zeros((n_clients,), bool)
        m[(round_idx * self.k + np.arange(self.k)) % n_clients] = True
        return m


@dataclass(frozen=True)
class BernoulliP(ParticipationSchedule):
    """Each client independently present with probability p; the
    participant count varies round to round, possibly to zero."""
    p: float
    seed: int = 0
    name: str = "bernoulli_p"

    def mask(self, round_idx: int, n_clients: int) -> np.ndarray:
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"bernoulli:{self.p} needs 0 <= p <= 1")
        rng = np.random.default_rng([self.seed, round_idx])
        return rng.random(n_clients) < self.p


class AdaptiveParticipation(ParticipationSchedule):
    """Closed-loop schedule: boosts a straggler's presence probability from
    its OBSERVED commit delays,

        p_i(t) = clip(p (1 + boost ema_i(t) / (1 + D_max)), p, 1),

    with ema_i a per-client EMA of the delays the server has observed (a
    commit born in round r arriving in round r + d is observed, with value
    d, in round r + d). The mask depends only on (p, boost, seed, the bound
    clock, round index): the observations are derived from the clock and
    the past masks, replayed through the relay's `HostEventQueue`, so two
    independently built instances agree round by round. Unbound (no clock),
    every observed delay is 0 and this is a Bernoulli draw of p.
    """
    name: str = "adaptive"

    def __init__(self, p: float = 0.5, boost: float = 1.0, seed: int = 0,
                 alpha: float = 0.3):
        if not 0.0 < p <= 1.0:
            raise ValueError(f"adaptive:{p} needs 0 < p <= 1")
        self.p, self.boost, self.seed, self.alpha = p, boost, seed, alpha
        self.clock = None
        self._masks: list = []          # per computed round: (N,) bool
        self._ema: Optional[np.ndarray] = None
        self._inflight = events.HostEventQueue()

    def bind_clock(self, clock) -> "AdaptiveParticipation":
        """Attach the fleet's ClockModel (the source of observed delays);
        before the first `mask` call."""
        if self._masks:
            raise ValueError("bind_clock must precede the first mask()")
        self.clock = clock
        return self

    def _probs(self, n_clients: int) -> np.ndarray:
        if self._ema is None:
            self._ema = np.zeros((n_clients,))
        d_max = self.clock.d_max if self.clock is not None else 0
        p = self.p * (1.0 + self.boost * self._ema / (1.0 + d_max))
        return np.clip(p, self.p, 1.0)

    def mask(self, round_idx: int, n_clients: int) -> np.ndarray:
        while len(self._masks) <= round_idx:
            t = len(self._masks)
            m = (np.random.default_rng([self.seed, 0xada, t])
                 .random(n_clients) < self._probs(n_clients))
            self._masks.append(m)
            delays = (self.clock.delays(t, n_clients)
                      if self.clock is not None
                      else np.zeros(n_clients, np.int64))
            for i in np.nonzero(m)[0]:
                self._inflight.push(birth=t, pos=int(i), client_id=int(i),
                                    stamp=0, payload=int(delays[i]),
                                    delay=int(delays[i]))
            # this round's arrivals (delay-0 births included), in commit
            # order
            for _, _, i, _, d, _ in self._inflight.pop_due(t):
                self._ema[i] = (1 - self.alpha) * self._ema[i] \
                    + self.alpha * d
        return self._masks[round_idx].copy()


def get_schedule(spec, seed: int = 0, clock=None) -> ParticipationSchedule:
    """Parse a CLI-style schedule spec into a schedule object.

    Specs: "full" | "uniform_k:K" | "cyclic:K" | "bernoulli:P" |
    "adaptive:P[,BOOST]", e.g. "uniform_k:8" or "adaptive:0.5,2". A
    ParticipationSchedule instance passes through unchanged; None means
    full participation. `clock` (a `repro_torch.sim` ClockModel) is bound
    to adaptive schedules.
    """
    if spec is None:
        return FullParticipation()
    if isinstance(spec, ParticipationSchedule):
        if isinstance(spec, AdaptiveParticipation) and clock is not None \
                and spec.clock is None:
            spec.bind_clock(clock)
        return spec
    name, args = parse_spec(
        spec, "participation schedule",
        ("full", "uniform_k", "cyclic", "bernoulli", "adaptive"),
        aliases={"bernoulli_p": "bernoulli"})
    if name == "full":
        return FullParticipation()
    if name == "uniform_k":
        return UniformK(k=int(args[0]), seed=seed)
    if name == "cyclic":
        return Cyclic(k=int(args[0]))
    if name == "bernoulli":
        return BernoulliP(p=float(args[0]), seed=seed)
    sched = AdaptiveParticipation(
        p=float(args[0]) if args else 0.5,
        boost=float(args[1]) if len(args) > 1 else 1.0, seed=seed)
    return sched.bind_clock(clock) if clock is not None else sched
