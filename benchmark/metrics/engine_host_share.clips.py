"""Percent of the traced window in which the host ran
``Separator.separate`` without waiting on the card, in the clip cell:
the program's ``separate`` spans less their ``separate.wait`` spans
(``waveunet_tpu_torch/tracing.py``), over the window. Per-request host
costs (staging, each chunk's enqueue, the stitch, the difference source)
set a clip's latency where its few windows keep the card busy briefly."""

from benchmark.program_trace import host_s, window_share

MOVES = "clip_latency_p95_ms"
UNIT = "%"
LAYER = "engine"


def read(ctx):
    return window_share(ctx, host_s)
