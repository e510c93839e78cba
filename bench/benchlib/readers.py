"""What the per-layer metric files share: the idle share, the whole
step's share of the peak, and a kernel's share of its roofline, each
from a run's trace and facts (`bench/run.py`'s RunInfo)."""
from __future__ import annotations

import re
from typing import Optional

from benchlib.device import PEAK_FLOPS


def idle_percent(run) -> Optional[float]:
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def mfu_percent(run) -> Optional[float]:
    """The window's required operations over its seconds and the peak of
    the dtype the configuration computes in."""
    f = run.facts
    if not f.get("window_flops") or run.window.seconds <= 0:
        return None
    peak = PEAK_FLOPS[f["peak_flops_dtype"]]
    return 100.0 * f["window_flops"] / (run.window.seconds * peak)


def symbols_pattern(symbols) -> "re.Pattern":
    return re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(
        re.escape(s) for s in symbols) + r")(?![A-Za-z0-9_])")


def kernel_seconds(run, op: str):
    """(records, device seconds) of the symbols the port declares for its
    wrapper `op` (`ops.KERNEL_SYMBOLS`), in the traced stretch."""
    syms = run.facts.get("kernel_symbols", {}).get(op)
    if not syms or run.trace is None:
        return 0, 0.0
    return run.trace.kernel_seconds(symbols_pattern(syms))
