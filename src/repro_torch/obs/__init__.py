"""Fleet observability: round telemetry, phase trace spans, sinks; the port
of `repro/obs/`.

Three tiers, one opt-in surface:

  1. `obs.metrics`: a fixed-shape `RoundTelemetry` of tensors, computed
     inside the vectorized engine's round step (ring occupancy and fill,
     owner diversity, staleness and commit-lag histograms, pending depth,
     stale reads, prototype drift, per-bucket loss and gradient norm), the
     same function the sequential engine computes over its equal ring;
  2. `obs.trace`: a `TraceRecorder` wrapping the round phases in
     `torch.profiler.record_function` and writing Chrome trace-event JSON
     (Perfetto), with `profile=True` waits for the device;
  3. `obs.sink` and `obs.report`: a JSONL writer of the round records and
     the `python -m repro_torch.obs.report` CLI that renders a run.

Both engines take `telemetry=`: None or False is off (the round step is
built exactly as without telemetry), True the metrics only, or a
`TelemetryConfig` for sinks and tracing.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.obs import metrics, sink, trace  # noqa: F401
# obs.report is NOT imported here: it is the `python -m
# repro_torch.obs.report` CLI, and importing it from the package would make
# runpy warn about the module's double identity.
from repro_torch.obs.metrics import (  # noqa: F401
    STALE_BINS, RoundTelemetry, round_telemetry, shard_summary, to_record)
from repro_torch.obs.sink import JsonlWriter, read_jsonl  # noqa: F401
from repro_torch.obs.trace import (NULL_SPAN, TraceRecorder,  # noqa: F401
                                   null_span)


@dataclass(frozen=True)
class TelemetryConfig:
    """What to observe and where it goes.

    metrics: compute the RoundTelemetry each round (a `telemetry` entry in
    every round record). jsonl: stream each round record to this JSONL
    path. trace: write the phase spans to this Chrome trace-event JSON path
    (rewritten every round). profile: each span waits for the device on its
    phase's outputs, which charges device time to the phase at the cost of
    overlap (records spans even without a trace path, for the recorder's
    own events)."""
    metrics: bool = True
    jsonl: Optional[str] = None
    trace: Optional[str] = None
    profile: bool = False


def resolve(telemetry) -> Optional[TelemetryConfig]:
    """The engines' `telemetry=`: None or False -> off (None), True -> the
    metrics only, a TelemetryConfig as given; anything else is a
    TypeError."""
    if telemetry is None or telemetry is False:
        return None
    if telemetry is True:
        return TelemetryConfig()
    if isinstance(telemetry, TelemetryConfig):
        return telemetry
    raise TypeError(
        f"telemetry= expects None, bool or obs.TelemetryConfig; got "
        f"{type(telemetry).__name__}")
