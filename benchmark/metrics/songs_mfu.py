"""Percent of the card's dense TF32 peak (495 TFLOP/s) that the window's
requests needed: the analytic FLOPs of every conv of the windows each
song needs (not the padded slots of a chunk, ``work.py``) over
the traced window. The whole request's share, the forward
(``models/waveunet.py``) and everything around it."""

from benchmark.trace import peak_share

MOVES = "separated_audio_s_per_s"
UNIT = "%"
LAYER = "forward"


def read(ctx):
    return peak_share(ctx)
