"""Static shape algebra for the Wave-U-Net stack.

Reimplements (bit-exactly) the valid-convolution shape bookkeeping of the reference's
``UnetAudioSeparator.get_padding`` (the reference's
``Models/UnetAudioSeparator.py:34-83``)
as pure-Python integer arithmetic. Everything downstream — window framing, dataset
context padding, inference stitching — hangs off these two numbers, so they are unit
tested with round-trip property checks (tests/test_shapes.py).

Per-layer identities (reference lines in parentheses):
  down conv (valid):      out = in - filter_size + 1          (:98)
  decimate by 2:          out = (in - 1) // 2 + 1             (:100)
  upsample (context):     out = 2 * in - 1                    (:115)
  upsample (no context):  out = 2 * in                        (:117)
  merge conv (valid):     out = in - merge_filter_size + 1    (:123)
"""

from __future__ import annotations

import math
from typing import Tuple

from waveunet_tpu_torch.config import Config


# The spectrogram net's STFT framing (waveunet_tpu/ops/stft.py FRAME_LEN,
# HOP); ops/stft.py takes its constants from here.
STFT_FRAME_LEN = 1024
STFT_HOP = 768


def stft_num_frames(n_samples: int) -> int:
    """Number of STFT frames the spectrogram net analyses in ``n_samples``."""
    if n_samples < STFT_FRAME_LEN:
        return 0
    return 1 + (n_samples - STFT_FRAME_LEN) // STFT_HOP


def down_out(n: int, filt: int, valid: bool) -> int:
    """Length after one valid/same conv of width `filt`."""
    return n - filt + 1 if valid else n


def decimate_out(n: int) -> int:
    """Length after x[::2] decimation."""
    return (n - 1) // 2 + 1


def upsample_out(n: int, context: bool) -> int:
    """Length after the x2 upsampling stage (2n-1 aligned-corners if context)."""
    return 2 * n - 1 if context else 2 * n


def get_padding(cfg: Config, num_frames: int) -> Tuple[int, int]:
    """Compute (input_len, output_len) in samples for a desired output length.

    For ``context=False`` shapes pass straight through (same-padding network,
    `UnetAudioSeparator.py:83`). For ``context=True`` this walks the desired output
    back to the bottleneck feature-map size, rounds up, then walks forward through
    both the up path (output) and down path (input) exactly as
    `UnetAudioSeparator.py:41-81` does.
    """
    if not cfg.context:
        # Same-padding mode needs every level's length to halve evenly, or the
        # x2 upsample cannot re-match its skip connection (the reference
        # asserts exactly this at graph-build time,
        # `UnetAudioSeparator.py:121`; its default 16384 = 2^14 always works).
        if cfg.network == "unet" and num_frames % (1 << cfg.num_layers) != 0:
            raise ValueError(
                f"num_frames={num_frames} must be divisible by "
                f"2^num_layers={1 << cfg.num_layers} for same-padding "
                f"(context=False) models")
        if cfg.network == "unet_spectrogram":
            # The 2-D U-Net halves (time_frames, 512 freqs) per layer; both
            # must divide cleanly (`UnetSpectrogramSeparator.py:69`'s assert).
            f = stft_num_frames(num_frames)
            if f < (1 << cfg.num_layers) or f % (1 << cfg.num_layers) != 0:
                raise ValueError(
                    f"num_frames={num_frames} gives {f} STFT frames, which "
                    f"must be a positive multiple of 2^num_layers="
                    f"{1 << cfg.num_layers} (use hop*(k*2^L - 1) + 1024)")
            # The window must also carry NO framing slack: samples beyond
            # hop*(F-1)+frame_len are never analysed, and the engine would
            # stitch that many zeros into every hop of the output — silent
            # wrong audio, not an error (round-2 review finding).
            istft_len = STFT_HOP * (f - 1) + STFT_FRAME_LEN
            if istft_len != num_frames:
                raise ValueError(
                    f"num_frames={num_frames} has {num_frames - istft_len} "
                    f"samples of STFT framing slack (iSTFT covers "
                    f"{istft_len}); use exactly hop*(k*2^L - 1) + 1024")
            if 512 % (1 << cfg.num_layers) != 0:
                raise ValueError("spectrogram net supports at most 9 layers "
                                 "(512 frequency bins must halve cleanly)")
        return num_frames, num_frames

    # Walk output -> bottleneck (`:43-54`). Uses float math + ceil like the
    # reference so rounding matches exactly.
    rem = float(num_frames)
    rem = rem - cfg.output_filter_size + 1
    for _ in range(cfg.num_layers):
        rem = rem + cfg.merge_filter_size - 1
        rem = (rem + 1.0) / 2.0
    x = int(math.ceil(rem))
    if x < 2:
        raise ValueError(
            f"desired output {num_frames} too small for {cfg.num_layers} layers")

    # Walk bottleneck -> input/output (`:57-76`).
    output_len = x
    input_len = x + cfg.filter_size - 1  # bottleneck conv
    for i in range(cfg.num_layers):
        output_len = 2 * output_len - 1                       # upsample
        output_len = output_len - cfg.merge_filter_size + 1   # merge conv
        input_len = 2 * input_len - 1                         # inverse decimation
        if i < cfg.num_layers - 1:
            input_len = input_len + cfg.filter_size - 1       # down conv
        else:
            input_len = input_len + cfg.input_filter_size - 1 # first down conv
    output_len = output_len - cfg.output_filter_size + 1

    # Consistency gate: the reference's inverse walk models decimation as
    # 2m-1 (`:70`), i.e. assumes every pre-decimation map is odd — true for
    # its odd filter widths, but an even filter width flips intermediate
    # parities and the walk then disagrees with what the network actually
    # produces. Fail loudly here instead of handing back shapes that crash
    # at loss time (round-2 review finding).
    actual = forward_output_len(cfg, int(input_len))
    if actual != int(output_len):
        raise ValueError(
            f"filter sizes {cfg.input_filter_size}/{cfg.filter_size}/"
            f"{cfg.merge_filter_size}/{cfg.output_filter_size} are outside "
            f"the valid-conv shape algebra's domain: get_padding predicts "
            f"output {int(output_len)} but the network produces {actual} "
            f"(context=True models need odd conv widths)")

    return int(input_len), int(output_len)


def forward_output_len(cfg: Config, input_len: int) -> int:
    """Simulate the forward pass length arithmetic: input length -> output length.

    This is the ground-truth check that `get_padding`'s inverse walk matches what the
    network actually produces (`UnetAudioSeparator.py:97-127` identities).
    Raises ValueError if any intermediate map would be non-positive.
    """
    valid = cfg.context
    n = input_len
    skips = []
    for i in range(cfg.num_layers):
        # The reference GRAPH uses filter_size for every down conv
        # (`UnetAudioSeparator.py:98`); input_filter_size appears only in its
        # inverse walk (`:73`), whose extra context the skip crops absorb.
        n = down_out(n, cfg.filter_size, valid)
        if n < 1:
            raise ValueError("feature map vanished in down path")
        skips.append(n)
        n = decimate_out(n)
    n = down_out(n, cfg.filter_size, valid)  # bottleneck conv
    if n < 1:
        raise ValueError("feature map vanished at bottleneck")
    for i in range(cfg.num_layers):
        n = upsample_out(n, cfg.context)
        skip_n = skips[-i - 1]
        if cfg.context:
            if skip_n < n:
                raise ValueError("skip connection shorter than upsampled map")
            n = n  # crop_and_concat crops the skip to n, length stays n
        else:
            if skip_n != n:
                raise ValueError(f"same-padding skip mismatch {skip_n} vs {n}")
        n = down_out(n, cfg.merge_filter_size, valid)
        if n < 1:
            raise ValueError("feature map vanished in up path")
    n = down_out(n, cfg.output_filter_size, valid)
    return n


def context_pad(cfg: Config, num_frames: int) -> int:
    """Number of context samples padded at each end: (input - output) // 2.

    Mirrors `Datasets.py:47-49` and `Evaluate.py:121`.
    """
    inp, out = get_padding(cfg, num_frames)
    return (inp - out) // 2


def pow2_ceil(n: int) -> int:
    """Smallest power of two >= n (shape-bucketing helper)."""
    b = 1
    while b < n:
        b *= 2
    return b


def auto_infer_frames(cfg, max_overlap: float = 3.0) -> int:
    """Smallest power-of-two inference window whose valid-conv context
    overlap (input_len / output_len) is <= ``max_overlap``.

    The context a window carries is architecture-constant (in - out), so
    growing the window amortises it: full_44KHz goes from 9.0x at the 16384
    training window to 3.0x at 65536 — a measured 2.1x compute-roof gain
    (DESIGN.md perf table). Non-context models pass through unchanged."""
    if not cfg.context:
        return cfg.num_frames
    frames = max(cfg.num_frames, 1024)
    while True:
        in_len, out_len = get_padding(cfg, frames)
        if in_len / out_len <= max_overlap or frames >= 1 << 22:
            return frames
        frames *= 2
