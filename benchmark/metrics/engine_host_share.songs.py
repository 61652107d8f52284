"""Percent of the traced window in which the host ran
``Separator.separate`` without waiting on the card, in the song cells:
the program's ``separate`` spans less their ``separate.wait`` spans
(``waveunet_tpu_torch/tracing.py``), over the window. The engine's host
work: the resampler, staging, each chunk's enqueue, the stitch and the
difference source (``infer/engine.py``)."""

from benchmark.program_trace import host_s, window_share

MOVES = "separated_audio_s_per_s"
UNIT = "%"
LAYER = "engine"


def read(ctx):
    return window_share(ctx, host_s)
