"""Streaming populations: client arrival and departure as a first-class
schedule; an own copy of `repro/sim/population.py` (numpy only), held
equal to it by tests/test_torch_population_shards.py.

The paper's fleet is not a fixed roster — users install the app, churn, and
come back. This module models that the same way `sim.clocks` models
lateness: deterministically, with no hidden RNG state, so the sequential
oracle and the vectorized engine independently derive the SAME cohort
timeline and stay equivalence-testable.

Population model. External client ids are drawn from an unbounded space
(an arrival counter, cycled modulo `population` so sweeps can dial the
distinct-id space from 10³ to 10⁶ and beyond). The engines never size
state by that space: a bounded `CohortTable` of A SEATS holds the
currently-admitted clients, and everything the engines allocate — client
params, masks, upload rows — is (A, ...), never (N_population, ...). Ring
slots are tagged with the EXTERNAL id, which is what keeps relay
bookkeeping (owner exclusion, shard hashing) correct across seat reuse.

Per round the table yields a `RoundView`:
  - departures: each active client leaves with probability `p_leave`. A
    departed client keeps its seat (and its ring slots stay live — its
    observations are still valid history) until the seat is reclaimed.
  - arrivals: Poisson(`rate`) new ids. An arrival takes a FREE seat first;
    otherwise it reclaims the least-recently-active DEPARTED seat (LRU),
    and the old owner's external id is reported in `evicted` — the engines
    then call `policy.evict_owners`, invalidating the evicted owner's ring
    slots. LRU never touches an ACTIVE seat: when every seat is active the
    arrival is dropped (counted in `dropped`) — admission control, not
    eviction of a live client. A cycled id that is already seated rejoins
    in place (departed -> active again) instead of taking a second seat.
  - participation: `k` of the active seats, uniformly without replacement
    (all of them when fewer than k are active). Participants refresh the
    seat's `last_active` round, which is the LRU key.

Determinism is recursive replay (the `AdaptiveParticipation` pattern):
`round(r)` replays rounds 0..r from the per-round seeded RNG stream
`default_rng([seed, 0x5EA7, r])`; views are cached, and two tables built
from the same spec agree bit-for-bit in either engine.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Union

import numpy as np

from repro_torch.specs import parse_spec

# Empty-seat sentinel. Matches relay.base.EMPTY_OWNER so a free seat's id
# can never collide with a live ring owner (real ids are >= 0; SEED_OWNER
# is -1). Pinned against the relay constant by
# tests/test_torch_population_shards.py.
FREE_SEAT = -2


class RoundView(NamedTuple):
    """One round's cohort, as fixed-size host arrays (A = seat count)."""
    seat_ids: np.ndarray     # (A,) int32: external id per seat (FREE_SEAT)
    active: np.ndarray       # (A,)  bool: seat holds a non-departed client
    mask: np.ndarray         # (A,)  bool: participates this round
    evicted: np.ndarray      # (E,) int32: owners LRU-evicted at round start


@dataclass(frozen=True)
class StreamingPopulation:
    """Arrival-schedule parameters (see module docstring)."""
    k: int = 2                       # participants per round (fixed k)
    rate: float = 2.0                # expected arrivals per round
    p_leave: float = 0.1             # per-round departure probability
    population: int = 2**31 - 1      # distinct external-id space
    seed: int = 0
    name: str = "stream"

    def __post_init__(self):
        if self.k < 1 or self.rate < 0 or not (0 <= self.p_leave <= 1):
            raise ValueError(f"bad streaming-population spec: {self}")
        if self.population < 1:
            raise ValueError("population must be positive")

    def table(self, n_seats: int) -> "CohortTable":
        return CohortTable(self, n_seats)


class CohortTable:
    """Bounded active-cohort table with LRU owner eviction (host-side)."""

    def __init__(self, pop: StreamingPopulation, n_seats: int):
        assert n_seats >= 1, n_seats
        self.pop = pop
        self.n_seats = n_seats
        self.seat_ids = np.full((n_seats,), FREE_SEAT, np.int32)
        self.active = np.zeros((n_seats,), bool)
        self.last_active = np.full((n_seats,), -1, np.int64)
        self.next_id = 0
        self.dropped = 0                 # arrivals refused (all seats active)
        self._rounds: List[RoundView] = []

    def round(self, r: int) -> RoundView:
        """The cohort view for round r (replays forward as needed)."""
        while len(self._rounds) <= r:
            self._rounds.append(self._step(len(self._rounds)))
        return self._rounds[r]

    def nbytes(self) -> int:
        """Table memory — O(seats), independent of the population."""
        return (self.seat_ids.nbytes + self.active.nbytes
                + self.last_active.nbytes)

    def _step(self, r: int) -> RoundView:
        pop, A = self.pop, self.n_seats
        rng = np.random.default_rng([pop.seed, 0x5EA7, r])

        # 1. departures (drawn for every seat, applied to active ones, so
        #    the RNG stream does not depend on the mutable table state)
        leave = rng.random(A) < pop.p_leave
        self.active &= ~leave

        # 2. arrivals
        evicted: List[int] = []
        for _ in range(int(rng.poisson(pop.rate))):
            cid = self.next_id % pop.population
            self.next_id += 1
            seated = np.nonzero(self.seat_ids == cid)[0]
            if seated.size:                       # cycled id rejoins in place
                self.active[seated[0]] = True
                continue
            free = np.nonzero(self.seat_ids == FREE_SEAT)[0]
            if free.size:
                seat = int(free[0])
            else:
                idle = np.nonzero(~self.active)[0]
                if not idle.size:                 # every seat active: refuse
                    self.dropped += 1
                    continue
                seat = int(idle[np.argmin(self.last_active[idle])])   # LRU
                evicted.append(int(self.seat_ids[seat]))
            self.seat_ids[seat] = cid
            self.active[seat] = True
            self.last_active[seat] = r            # admission counts as activity
        # 3. participation: k of the active seats, uniform w/o replacement
        mask = np.zeros((A,), bool)
        idx = np.nonzero(self.active)[0]
        if idx.size:
            take = min(pop.k, idx.size)
            mask[rng.choice(idx, size=take, replace=False)] = True
            self.last_active[mask] = r
        return RoundView(seat_ids=self.seat_ids.copy(),
                         active=self.active.copy(), mask=mask,
                         evicted=np.asarray(evicted, np.int32))


def get_arrivals(spec: Union[str, StreamingPopulation, None],
                 ) -> Optional[StreamingPopulation]:
    """Resolve an arrival-schedule spec: None | instance |
    "stream[:k[,rate[,p_leave[,population[,seed]]]]]"."""
    if spec is None or isinstance(spec, StreamingPopulation):
        return spec
    name, args = parse_spec(spec, "arrival schedule",
                            {"stream": StreamingPopulation})
    kw = {}
    for field_name, cast, val in zip(
            ("k", "rate", "p_leave", "population", "seed"),
            (int, float, float, int, int), args):
        kw[field_name] = cast(val)
    return StreamingPopulation(**kw)
