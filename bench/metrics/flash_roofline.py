"""flash_roofline: the least time of the traced prefills' flash attention
calls (one a layer a prefill, causal pairs only; operations and bytes from
the shapes, `benchlib/flops.py`) over their device time, the profiler's
time for the symbols `ops.KERNEL_SYMBOLS` declares for the wrapper."""
from benchlib import flops
from benchlib.readers import kernel_seconds


def read(run):
    calls = run.facts.get("flash_calls")
    if not calls:
        return None
    n, t = kernel_seconds(run, "flash_attention")
    if n != len(calls) or t <= 0:
        # a record the profiler dropped would pair a call with no time
        return None
    dt, elem = run.facts["peak_flops_dtype"], run.facts["flash_elem"]
    least = sum(flops.least_seconds(*flops.flash_cost(*c, elem), dt)
                for c in calls)
    return 100.0 * least / t
