"""Deterministic fleet simulation: virtual-time client clocks (an own copy
of the reference's `repro/sim/clocks.py`) and streaming populations (an own
copy of `repro/sim/population.py`). An upload clock (`FleetConfig.clock`)
delays commits through the relay's event log, a download clock
(`FleetConfig.download_clock`) makes clients read stale snapshots from the
history ring, `AdaptiveParticipation` boosts the upload clock's
stragglers, and an arrival schedule (`FleetConfig.arrivals`) streams
clients through a bounded seat table with LRU owner eviction."""
from repro_torch.sim.clocks import (ClockModel, HomogeneousClock,  # noqa: F401
                                    LognormalClock, PeriodicClock,
                                    PeriodicSyncClock, get_clock,
                                    get_download_clock)
from repro_torch.sim.population import (FREE_SEAT,  # noqa: F401
                                        CohortTable, RoundView,
                                        StreamingPopulation, get_arrivals)
