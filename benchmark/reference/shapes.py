"""Wave-U-Net's valid-convolution shape algebra, written out plainly.

The model (Stoller et al. 2018, section 3.1, and the authors' published
``UnetAudioSeparator.get_padding``) computes, for a desired output length,
the bottleneck length by walking the output back through the output conv,
the merge convs and the x2 upsamplings, rounding up, and then walks forward
to the input and output lengths a window really has.
"""

from __future__ import annotations

import math
from typing import Mapping, Tuple


def get_padding(arch: Mapping, num_frames: int) -> Tuple[int, int]:
    """(input_len, output_len) of a window whose desired output is
    ``num_frames``; ``arch`` holds the configuration's keys."""
    if not arch["context"]:
        return num_frames, num_frames
    L = arch["num_layers"]
    rem = float(num_frames) - arch["output_filter_size"] + 1
    for _ in range(L):
        rem = (rem + arch["merge_filter_size"] - 1 + 1.0) / 2.0
    x = int(math.ceil(rem))
    out_len = x
    in_len = x + arch["filter_size"] - 1
    for i in range(L):
        out_len = 2 * out_len - 1 - arch["merge_filter_size"] + 1
        in_len = 2 * in_len - 1 + (arch["filter_size"] if i < L - 1
                                   else arch["input_filter_size"]) - 1
    return in_len, out_len - arch["output_filter_size"] + 1


def infer_frames(arch: Mapping) -> int:
    """The inference window's desired output: ``infer_num_frames``, or with
    -1 the smallest power of two (from ``num_frames``, at least 1024) whose
    input is at most three times its output."""
    frames = arch["infer_num_frames"]
    if frames is None:
        return arch["num_frames"]
    if frames != -1:
        return frames
    if not arch["context"]:
        return arch["num_frames"]
    frames = max(arch["num_frames"], 1024)
    while True:
        i, o = get_padding(arch, frames)
        if i <= 3 * o or frames >= 1 << 22:
            return frames
        frames *= 2

