"""Song separation, written from the engine's documented semantics.

A stereo model takes a stereo song (a mono one is repeated on both
channels) and resamples it to the model's rate. A song shorter than one
network input is zero-padded at its end to one input, and the padding is
cut from the result. The song is padded with ``(input - output) // 2``
zeros of context on both sides; windows start every output length, the
last one right-aligned at the song's end; each window's outputs are
written into the song in window order, so a later window overwrites the
overlap. With the difference output the last source is
``clip(mix - sum(others), -1, 1)`` from the stitched sources.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch

from benchmark.reference import resample as rs
from benchmark.reference.sources import source_names

# windows [k, in_len, C] -> {source: [k, out_len, C]}
Forward = Callable[[torch.Tensor], Dict[str, torch.Tensor]]


def separate(forward: Forward, window: Tuple[int, int], arch: Mapping,
             mix: np.ndarray, sr: int, device: torch.device,
             batch: int = 16) -> Dict[str, np.ndarray]:
    """(frames, channels) float32 audio at ``sr`` -> {source: float32
    (frames at the model rate, channels)}. ``forward`` is the network's
    reference forward and ``window`` its (input, output) lengths; windows
    go through it ``batch`` at a time."""
    x = torch.as_tensor(np.ascontiguousarray(mix), device=device)
    if x.shape[1] == 1:
        x = x.repeat(1, 2)
    x = rs.resample(x, sr, arch["expected_sr"])
    in_len, out_len = window
    pad = (in_len - out_len) // 2
    n = x.shape[0]
    n_total = max(n, in_len)
    padded = torch.zeros((n_total + 2 * pad, x.shape[1]),
                         dtype=torch.float32, device=device)
    padded[pad:pad + n] = x
    starts = list(range(0, n_total, out_len))
    starts = [min(s, n_total - out_len) for s in starts]
    names = source_names(arch)
    diff = arch["output_type"] == "difference"
    out = {}
    for b0 in range(0, len(starts), batch):
        group = starts[b0:b0 + batch]
        wins = torch.stack([padded[s:s + in_len] for s in group])
        y = forward(wins)
        for name in (names[:-1] if diff else names):
            buf = out.setdefault(name, torch.zeros(
                (n_total, x.shape[1]), dtype=torch.float32, device=device))
            for s, w in zip(group, y[name]):
                buf[s:s + out_len] = w
    out = {k: v[:n] for k, v in out.items()}
    if diff:
        acc = 0
        for name in names[:-1]:
            acc = acc + out[name]
        out[names[-1]] = torch.clamp(x - acc, -1.0, 1.0)
    return {k: v.cpu().numpy() for k, v in out.items()}
