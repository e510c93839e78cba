"""disc_loss_roofline: the least time of the traced rounds' disc_loss
calls (forward and backward; operations and bytes from the call's shapes,
`benchlib/flops.py`) over their device time, which is the profiler's time
for the symbols `ops.KERNEL_SYMBOLS` declares for the two wrappers."""
from benchlib import flops
from benchlib.readers import kernel_seconds


def read(run):
    shape = run.facts.get("disc_shape")
    if shape is None:
        return None
    nf, tf = kernel_seconds(run, "disc_loss_fwd")
    nb, tb = kernel_seconds(run, "disc_loss_bwd")
    if nf + nb == 0 or tf + tb <= 0:
        return None
    dt = run.facts["peak_flops_dtype"]
    least = (nf * flops.least_seconds(*flops.disc_fwd_cost(*shape), dt)
             + nb * flops.least_seconds(*flops.disc_bwd_cost(*shape), dt))
    return 100.0 * least / (tf + tb)
