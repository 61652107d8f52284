"""Percent of the traced window in which the host waited on the card
inside ``Separator.separate`` (the program's ``separate.wait`` spans
around each chunk's ``event.synchronize()``), in the song cells: the part
of a request that a faster forward shortens and host work does not."""

from benchmark.program_trace import wait_s, window_share

MOVES = "separated_audio_s_per_s"
UNIT = "%"
LAYER = "engine"


def read(ctx):
    return window_share(ctx, wait_s)
