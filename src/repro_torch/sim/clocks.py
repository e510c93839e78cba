"""ClockModel — deterministic virtual-time client clocks; an own copy of
`repro/sim/clocks.py` (numpy only), held equal to it by
tests/test_torch_participation.py.

Cross-device clients do not share a wall clock: an upload produced in round
r arrives at the server some rounds later (slow hardware, duty-cycled
radios, flaky links). A `ClockModel` captures that lateness as a pure
function of `(client_id, round_idx)`:

    delays(round_idx, n_clients) -> (N,) int array, each in [0, d_max]

where entry i is the COMMIT DELAY of client i's round-`round_idx` upload:
the upload is appended to the relay at round `round_idx + delay` (delay 0 =
the synchronous behavior). Bounding delays by `d_max` is what keeps the
engines' pending-upload buffers fixed-shape (see the reference's
relay/events.py); `d_max = 0` degenerates to today's synchronous round.

Determinism is the load-bearing property, exactly as for participation
schedules: delays depend only on the model's parameters and the round
index — never on call order or hidden RNG state — so the sequential oracle
and the vectorized engine independently derive identical event timelines
and stay bit-exact equivalence-testable.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.specs import parse_spec


class ClockModel:
    name: str = "abstract"
    d_max: int = 0

    def delays(self, round_idx: int, n_clients: int) -> np.ndarray:
        """(N,) int64 commit delays for uploads born this round."""
        raise NotImplementedError


@dataclass(frozen=True)
class HomogeneousClock(ClockModel):
    """Every client commits with the same constant delay (delay 0 = the
    synchronous fleet). `d_max` may exceed `delay` to force the async
    pending-buffer machinery while all delays are still 0 — the bit-compat
    probe the tests use."""
    delay: int = 0
    d_max: int = -1          # -1 -> delay
    name: str = "homogeneous"

    def __post_init__(self):
        assert self.delay >= 0, self.delay
        if self.d_max < 0:
            object.__setattr__(self, "d_max", self.delay)
        assert self.delay <= self.d_max, (self.delay, self.d_max)

    def delays(self, round_idx: int, n_clients: int) -> np.ndarray:
        return np.full((n_clients,), self.delay, np.int64)


@dataclass(frozen=True)
class LognormalClock(ClockModel):
    """Straggler fleet: each client has a persistent speed drawn once from
    a lognormal (the classic heavy-tailed device-speed distribution), plus
    i.i.d. per-round jitter; delays are the rounded slowdown over the
    fastest client, clipped to d_max. A few clients are consistently slow
    (the stragglers), most commit immediately."""
    d_max: int = 4
    sigma: float = 1.0
    jitter: float = 0.25
    seed: int = 0
    name: str = "lognormal"

    def __post_init__(self):
        assert self.d_max >= 0, self.d_max

    def _base(self, n_clients: int) -> np.ndarray:
        """Per-client persistent slowdown in [0, inf): round-independent."""
        rng = np.random.default_rng([self.seed, 0x10c])
        return np.exp(self.sigma * rng.standard_normal(n_clients)) - 1.0

    def delays(self, round_idx: int, n_clients: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed, 0xde1a, round_idx])
        jit = 1.0 + self.jitter * rng.standard_normal(n_clients)
        d = np.rint(self._base(n_clients) * np.maximum(jit, 0.0))
        return np.clip(d, 0, self.d_max).astype(np.int64)


@dataclass(frozen=True)
class PeriodicClock(ClockModel):
    """Duty-cycled availability: client i's uplink window recurs every
    `period` rounds (phase i mod period). An upload born inside the window
    commits immediately; one born off-window waits for the next window —
    delay = rounds until the client's next uplink slot, capped at d_max."""
    d_max: int = 4
    period: int = 3
    name: str = "periodic"

    def __post_init__(self):
        assert self.period > 0 and self.d_max >= 0

    def delays(self, round_idx: int, n_clients: int) -> np.ndarray:
        i = np.arange(n_clients)
        wait = (i - round_idx) % self.period     # rounds to next open window
        return np.minimum(wait, self.d_max).astype(np.int64)


def get_clock(spec, seed: int = 0):
    """Parse a CLI-style clock spec into a ClockModel (or pass one through).

    Specs: None (synchronous) | "none" | "homogeneous[:delay]" |
    "lognormal[:d_max[,sigma]]" | "periodic[:d_max[,period]]", e.g.
    "lognormal:4" or "periodic:2,3". Returns None for the synchronous
    fleet so callers can branch on `clock is None or clock.d_max == 0`.
    """
    if spec is None:
        return None
    if isinstance(spec, ClockModel):
        return spec
    name, args = parse_spec(
        spec, "clock model",
        ("none", "homogeneous", "lognormal", "periodic"),
        aliases={"sync": "none"})
    if name == "none":
        return None
    if name == "homogeneous":
        return HomogeneousClock(delay=int(args[0]) if args else 0)
    if name == "lognormal":
        return LognormalClock(d_max=int(args[0]) if args else 4,
                              sigma=float(args[1]) if len(args) > 1 else 1.0,
                              seed=seed)
    # periodic
    return PeriodicClock(d_max=int(args[0]) if args else 4,
                         period=int(args[1]) if len(args) > 1 else 3)


@dataclass(frozen=True)
class PeriodicSyncClock(ClockModel):
    """Duty-cycled DOWNLOAD staleness — the time-forward mirror of
    `PeriodicClock`: client i last completed a sync at its most recent
    window (phase i mod period), so the snapshot it trains against in
    round t is `(t − i) mod period` rounds stale — age GROWS 0, 1, ...,
    period−1 between windows and resets at the next sync, capped at
    d_max. (`PeriodicClock`'s rounds-UNTIL-next-window delay is correct
    for uploads but would make a downloader's observed history run
    backwards in time.)"""
    d_max: int = 4
    period: int = 3
    name: str = "periodic_sync"

    def __post_init__(self):
        assert self.period > 0 and self.d_max >= 0

    def delays(self, round_idx: int, n_clients: int) -> np.ndarray:
        i = np.arange(n_clients)
        since = (round_idx - i) % self.period    # rounds since last window
        return np.minimum(since, self.d_max).astype(np.int64)


# Seed fold separating the download-lag clock from the upload clock: the
# same seed (and even the same spec string) must yield DECORRELATED upload
# and download lateness — a device's radio being busy on the uplink says
# nothing about how stale its last sync is.
_DOWNLOAD_SEED_FOLD = 0xD1


def get_download_clock(spec, seed: int = 0):
    """Parse a DOWNLOAD-lag clock: same model zoo and spec strings as
    `get_clock`, but entry i of `delays(t, N)` is how many rounds STALE
    client i's relay snapshot is when it trains in round t — it reads the
    snapshot its round-`t − d` self would have read fresh (the post-merge
    state of round `t − d − 1`, via the relay history ring,
    the reference's relay/history.py). `d_max` bounds the lag, so engines retain
    `H_max = d_max + 1` snapshots; delay 0 (or None) is today's
    round-fresh download. A ClockModel instance passes through unchanged;
    string specs are seeded through an independent fold so upload and
    download clocks built from one seed decorrelate, and "periodic"
    resolves to `PeriodicSyncClock` (rounds SINCE the last sync window —
    staleness must grow between syncs, not count down)."""
    if isinstance(spec, ClockModel):
        return spec
    c = get_clock(spec, seed=seed ^ _DOWNLOAD_SEED_FOLD)
    if isinstance(c, PeriodicClock):
        return PeriodicSyncClock(d_max=c.d_max, period=c.period)
    return c
