"""mfu.train: the model's operations per unit (portbench/yardstick.py; a
training step counts its backward as twice its forward) over the untraced
part of the window, as a share of the card's 495 TFLOP/s TF32 peak."""

from portbench.metrics._common import mfu_pct


def read(view):
    return mfu_pct(view)
