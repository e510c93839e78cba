"""mfu.serve: the operations the window's prefills require (2 x active
parameters x tokens plus causal attention; `benchlib/flops.py`) over the
window's seconds, from the first batch due to the last answer, and the
card's bf16 dense peak (989 TFLOP/s)."""
from benchlib.readers import mfu_percent


def read(run):
    return mfu_percent(run)
