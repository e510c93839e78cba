"""mfu.fleet: the operations the fleet's rounds require (training, upload
and eval forwards of LeNet5, `benchlib/flops.py`) over the window's
seconds and the card's float32 peak (67 TFLOP/s, TF32 off)."""
from benchlib.readers import mfu_percent


def read(run):
    return mfu_percent(run)
