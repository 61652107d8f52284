"""Percent of the traced window spent in the program's resampler (its
``resample`` spans, the host and the device implementation alike), in
the song cells: all of the work for songs fed at another rate than the
model's, a pass-through at the model's rate."""

from benchmark.program_trace import resample_s, window_share

MOVES = "separated_audio_s_per_s"
UNIT = "%"
LAYER = "engine"


def read(ctx):
    return window_share(ctx, resample_s)
