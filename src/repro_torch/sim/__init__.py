"""Deterministic fleet simulation: virtual-time client clocks (an own copy
of the reference's `repro/sim/clocks.py`). In this slice a clock only feeds
`relay.participation.AdaptiveParticipation.bind_clock`; the trainers refuse
`FleetConfig.clock` and `download_clock` until asynchrony (ROADMAP slice
4)."""
from repro_torch.sim.clocks import (ClockModel, HomogeneousClock,  # noqa: F401
                                    LognormalClock, PeriodicClock,
                                    PeriodicSyncClock, get_clock,
                                    get_download_clock)
