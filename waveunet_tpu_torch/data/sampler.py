"""Snippet positions, extraction, augmentation and target crop, in numpy.

A copy of ``waveunet_tpu/data/sampler.py`` for the host pipeline:
  * uniform random snippet starts in [0, length - input_len);
  * deterministic eval starts with hop = output length;
  * windows gathered by a numpy index (the JAX package may take a native
    memcpy loop; the values are the same);
  * random source attenuation U(0.7, 1.0) with the mix re-summed;
  * the sources centre-cropped to the output window.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def random_snippet_positions(rng: np.random.Generator, length: int,
                             input_len: int, n: int) -> np.ndarray:
    """Uniform random starts in [0, length - input_len)."""
    hi = length - input_len
    if hi <= 0:
        return np.zeros((n,), np.int64)
    return rng.integers(0, hi, size=n, dtype=np.int64)


def sequential_snippet_positions(length: int, input_len: int,
                                 output_len: int) -> np.ndarray:
    """Strided starts with hop = output_len."""
    return np.arange(0, max(length - input_len, 1), output_len,
                     dtype=np.int64)


def extract_snippets(tracks: Dict[str, np.ndarray], positions: np.ndarray,
                     input_len: int) -> Dict[str, np.ndarray]:
    """[n, input_len, ch] windows at ``positions`` for every key."""
    idx = np.asarray(positions, np.int64)[:, None] + np.arange(input_len)
    return {key: np.asarray(audio, np.float32)[idx]
            for key, audio in tracks.items()}


def random_amplify(sample: Dict[str, np.ndarray], rng: np.random.Generator,
                   source_names: Sequence[str]) -> Dict[str, np.ndarray]:
    """Scale each snippet's sources by U(0.7, 1.0), one draw per (snippet,
    source), and re-sum the mix."""
    n = sample[source_names[0]].shape[0]
    out = {}
    mix = None
    for key in source_names:
        scale = rng.uniform(0.7, 1.0, size=(n, 1, 1)).astype(np.float32)
        scaled = sample[key] * scale
        out[key] = scaled
        mix = scaled if mix is None else mix + scaled
    out["mix"] = mix
    return out


def crop_targets(sample: Dict[str, np.ndarray], pad_frames: int,
                 source_names: Sequence[str]) -> Dict[str, np.ndarray]:
    """Crop each source (not the mix) by pad_frames at both ends."""
    if pad_frames <= 0:
        return sample
    out = dict(sample)
    for key in source_names:
        out[key] = sample[key][:, pad_frames:-pad_frames, :]
    return out
