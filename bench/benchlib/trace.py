"""A `torch.profiler` capture of part of the timed window, reduced to what
the per-layer metrics read: device intervals, the host's launch calls, the
host's own spans, and a breakdown of device time and idle gaps.

The profiler drops the first device records of a window, more of them
the more a process has profiled, so each capture opens with MARKERS spin
kernels (`torch.cuda._sleep`) that are left out of everything below. A
capture with no device record besides them fails loudly: a share read
from an empty trace would be a guess.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

MARKERS = 256
MARKER = "spin_kernel"
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemcpy",
                "cudaMemcpy2DAsync", "cudaMemsetAsync", "cudaMemset",
                "cudaGraphLaunch")


class EmptyTrace(RuntimeError):
    """The profiler kept no device record of the traced window."""


class Trace:
    """What one capture saw. Times are seconds; intervals are (start, end)
    on the profiler's clock, device and host alike."""

    def __init__(self, device: List[Tuple[str, float, float]],
                 host: List[Tuple[str, float, float, bool]],
                 launches: int, window: Tuple[float, float]):
        self.device = sorted(device, key=lambda d: d[1])
        self.host = host
        self.launches = launches
        self.window = window

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device intervals, clipped to the window."""
        lo, hi = self.window
        out: List[List[float]] = []
        for _, a, b in self.device:
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def kernel_seconds(self, pattern) -> Tuple[int, float]:
        """(records, device seconds) of the device records whose name
        matches `pattern`."""
        hits = [b - a for n, a, b in self.device if pattern.search(n)]
        return len(hits), sum(hits)

    def top_device_ops(self, k: int = 10) -> List[List]:
        tot: Dict[str, float] = defaultdict(float)
        for n, a, b in self.device:
            tot[n] += b - a
        return [[n[:120], s] for n, s in
                sorted(tot.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """Idle time between device intervals inside the window, summed by
        what the host was doing when each gap opened: the innermost span
        (a user annotation) and the innermost operation open then."""
        lo, hi = self.window
        gaps, t = [], lo
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
        host = sorted(self.host, key=lambda h: h[1])
        tot: Dict[str, float] = defaultdict(float)
        spans: List = []                  # open annotations, innermost last
        ops: List = []                    # open operations, innermost last
        j = 0
        for a, b in gaps:                 # in time order
            while j < len(host) and host[j][1] <= a:
                stack = spans if host[j][3] else ops
                while stack and stack[-1][2] < host[j][1]:
                    stack.pop()
                stack.append(host[j])
                j += 1
            for stack in (spans, ops):
                while stack and stack[-1][2] < a:
                    stack.pop()
            label = "/".join(x[0] for x in (spans[-1:] + ops[-1:])) \
                or "host outside any operation"
            tot[label] += b - a
        return [[n, s] for n, s in
                sorted(tot.items(), key=lambda kv: -kv[1])[:k]]


def capture(fn: Callable[[], None]) -> Trace:
    """fn() under torch.profiler (CPU and CUDA activity), opened with the
    marker kernels; -> the reduced Trace of fn's part. Raises EmptyTrace
    when the profiler kept no device record of fn."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(MARKERS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        with torch.profiler.record_function("bench_window"):
            fn()
            torch.cuda.synchronize()
    device, host, launch_at = [], [], []
    window: Optional[Tuple[float, float]] = None
    for e in prof.events():
        a, b = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        user = bool(getattr(e, "is_user_annotation", False))
        if e.device_type == DeviceType.CUDA:
            # device-side copies of the host's annotations span the device
            # time of their range: they are no operation of the device
            kind = str(getattr(e, "activity_type", "") or "")
            if user or "annotation" in kind.lower() or MARKER in e.name:
                continue
            device.append((e.name, a, b))
            continue
        if e.name == "bench_window":
            window = (a, b)
            continue
        if e.name in LAUNCH_CALLS:
            launch_at.append(a)
        host.append((e.name, a, b, user))
    annotations = {h[0] for h in host if h[3]}
    device = [d for d in device if d[0] not in annotations]
    if window is None or not device:
        raise EmptyTrace("the profiler kept no device record of the traced "
                         "window")
    launches = sum(window[0] <= t <= window[1] for t in launch_at)
    return Trace(device, host, launches, window)

