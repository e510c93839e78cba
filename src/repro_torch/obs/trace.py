"""Host trace spans around the round phases, as Chrome trace-event JSON; the
port of `repro/obs/trace.py`.

A `TraceRecorder`'s `span(name)` wraps a round phase (evict, teacher read,
update, upload, commit, round step, eval) in
`torch.profiler.record_function(name)`, so the phases show up in a
`torch.profiler` capture, and records the host's begin and end as a
complete ("ph": "X") event with times in microseconds. `write()` dumps them
as JSON that Perfetto (https://ui.perfetto.dev, "Open trace file") or
chrome://tracing loads.

CUDA runs asynchronously: a bare span around a device call times its
DISPATCH. With `profile=True` a span waits at its exit for the outputs
handed to `sp.block(...)` (a stream synchronize when they live on the card,
nothing on the CPU), so the phase is charged its device time. The default
keeps spans free of waits, so tracing never changes the overlap it
observes; span times then mean host time until dispatch returned, still the
right lens for a host-bound fleet.
"""
from __future__ import annotations

import json
import os
import time

import torch
from torch.utils import _pytree


class _NullSpan:
    """No-op span: what `null_span` returns, so the engines can write
    `with self._span("phase") as sp: ...; sp.block(out)` unconditionally."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def block(self, outputs):
        return outputs


NULL_SPAN = _NullSpan()


def null_span(name: str, **args):
    """A span factory with `TraceRecorder.span`'s signature that records
    nothing: what the engines bind when tracing is off."""
    return NULL_SPAN


def _wait_for(outputs):
    """Waits until the device has produced every CUDA tensor in `outputs`
    (any nesting of tuples, lists and dicts): one synchronize of the current
    stream of each device they live on."""
    devices = {leaf.device for leaf in _pytree.tree_leaves(outputs)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()


class _Span:
    def __init__(self, rec: "TraceRecorder", name: str, args: dict):
        self._rec, self._name, self._args = rec, name, args
        self._ann = torch.profiler.record_function(name)
        self._sync = None

    def block(self, outputs):
        """Registers outputs to wait for at the span's exit (profile mode
        only); returns them unchanged."""
        self._sync = outputs
        return outputs

    def __enter__(self):
        self._ann.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._rec.profile and self._sync is not None and exc_type is None:
            _wait_for(self._sync)
        t1 = time.perf_counter()
        self._ann.__exit__(exc_type, exc, tb)
        self._rec._add(self._name, self._t0, t1, self._args)
        return False


class TraceRecorder:
    """Collects phase spans as Chrome trace events.

    path: where `write()` goes by default (the engines rewrite it after
    every round, so the trace can be read mid-run and survives an
    interrupt). profile: each span waits at its exit for its registered
    outputs (see the module docstring)."""

    def __init__(self, path: str = None, profile: bool = False):
        self.path = path
        self.profile = profile
        self.events = []
        self._origin = time.perf_counter()

    def span(self, name: str, **args):
        return _Span(self, name, args)

    def _add(self, name: str, t0: float, t1: float, args: dict):
        ev = {"name": name, "ph": "X", "pid": 1, "tid": 1,
              "ts": round((t0 - self._origin) * 1e6, 3),
              "dur": round((t1 - t0) * 1e6, 3)}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def write(self, path: str = None):
        path = path or self.path
        if not path:
            return
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events,
                       "displayTimeUnit": "ms"}, f)
