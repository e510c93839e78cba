"""mfu.train: the operations the window's train steps require (6 x
active parameters x tokens plus causal attention, no recompute;
`benchlib/flops.py`) over the window's seconds and the card's bf16 dense
peak (989 TFLOP/s)."""
from benchlib.readers import mfu_percent


def read(run):
    return mfu_percent(run)
