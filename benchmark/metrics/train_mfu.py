"""Percent of the card's dense TF32 peak (495 TFLOP/s) that the window's
training steps needed: three times the forward's analytic conv FLOPs a
window (the forward, and the backward's two products a conv) x batch x
steps, over the traced window (``train/step.py``)."""

from benchmark.trace import peak_share

MOVES = "trained_audio_s_per_s"
UNIT = "%"
LAYER = "training step"


def read(ctx):
    return peak_share(ctx)
