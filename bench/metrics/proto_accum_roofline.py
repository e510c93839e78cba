"""proto_accum_roofline: the least time of the traced steps' proto_accum
calls (one a step: every client's features by label into (N, V, d') sums;
operations and bytes from the shapes, `benchlib/flops.py`) over their
device time, the profiler's time for the symbols `ops.KERNEL_SYMBOLS`
declares for the wrapper."""
from benchlib import flops
from benchlib.readers import kernel_seconds


def read(run):
    shape = run.facts.get("proto_shape")
    if shape is None:
        return None
    n, t = kernel_seconds(run, "proto_accum")
    if n == 0 or t <= 0:
        return None
    least = n * flops.least_seconds(*flops.proto_accum_cost(*shape),
                                    "float32")
    return 100.0 * least / t
