"""Percent of the traced window in which the card ran no kernel, copy or
memset (1 - the union of device activity on the profiler's timeline over
the window), in the training cells: the host's turn between graph
replays of the fused epoch (``train/step.py``)."""

from benchmark.trace import idle_share

MOVES = "trained_audio_s_per_s"
UNIT = "%"
LAYER = "device"


def read(ctx):
    return idle_share(ctx)
