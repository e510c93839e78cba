"""Deterministic fleet simulation: virtual-time client clocks (an own copy
of the reference's `repro/sim/clocks.py`). An upload clock
(`FleetConfig.clock`) delays commits through the relay's event log, a
download clock (`FleetConfig.download_clock`) makes clients read stale
snapshots from the history ring, and `AdaptiveParticipation` boosts the
upload clock's stragglers."""
from repro_torch.sim.clocks import (ClockModel, HomogeneousClock,  # noqa: F401
                                    LognormalClock, PeriodicClock,
                                    PeriodicSyncClock, get_clock,
                                    get_download_clock)
