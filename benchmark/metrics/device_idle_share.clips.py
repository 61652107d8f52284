"""Percent of the traced window in which the card ran no kernel, copy or
memset (1 - the union of device activity on the profiler's timeline over
the window), in the clip cell: what the engine's host pipeline
(``infer/engine.py``: staging, copies, stitching, the difference source,
the resampler) leaves the device waiting."""

from benchmark.trace import idle_share

MOVES = "clip_latency_p95_ms"
UNIT = "%"
LAYER = "device"


def read(ctx):
    return idle_share(ctx)
