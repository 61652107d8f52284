"""Percent: the least time of the window's conv + bias + LeakyReLU calls
over the device time of the port's kernel for them
(``ops/kernels/csrc/conv1d_lrelu.cu``). A call's least time is the larger
of its FLOPs (counted once) over 495 TFLOP/s and its bytes (each input
byte read once, each output byte written once) over 3.35 TB/s, for the
windows the requests need (``work.py``). The kernel's time is its main
function's events plus its split-K reduction's; the main events must
number the launches the kernel's counter saw."""

import re

from benchmark.trace import roofline

MOVES = "separated_audio_s_per_s"
UNIT = "%"
LAYER = "kernels"
MAIN = re.compile(r"conv1d_lrelu_tc_kernel")
# the reduction of conv1d_lrelu.cu: six arguments (the im2col kernel's
# reduction of the same name takes seven)
REDUCE = re.compile(r"splitk_reduce_kernel\((?:[^,()]*,){5}[^,()]*\)")


def read(ctx):
    return roofline(ctx, "conv", MAIN, REDUCE, counter="conv1d_lrelu")
