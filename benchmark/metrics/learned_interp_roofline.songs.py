"""Percent: the least time of the window's learned x2 interpolations over
the device time of the port's kernel for them
(``ops/kernels/csrc/learned_interp.cu``): the larger of FLOPs over 495
TFLOP/s and bytes (each input byte read once, each output byte written
once) over 3.35 TB/s, for the windows the requests need. Its events must
number the launches the kernel's counter saw. Nothing to read where the
configuration upsamples bilinearly."""

import re

from benchmark.trace import roofline

MOVES = "separated_audio_s_per_s"
UNIT = "%"
LAYER = "kernels"
MAIN = re.compile(r"learned_interp_kernel")


def read(ctx):
    return roofline(ctx, "interp", MAIN, counter="learned_interp")
