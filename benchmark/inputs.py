"""Everything a run feeds the program, made from ``--seed`` on the device.

Weights: one uniform draw from a ``torch.Generator`` on the run's device,
cut into the leaves of the model family's layout and scaled per leaf
(``uniform_leaves``; the layout and the scales are the family's,
``families/``).

Audio: stereo float32 "songs" that sound like something: a few partials
(log-uniform 55-3,520 Hz) under slow amplitude swells, panned, over noise,
scaled under 0.9 of full scale. A mix's lengths are fixed by its traffic
file; the seed chooses the audio and the order.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, Sequence

import numpy as np
import torch


def uniform_leaves(layout: Mapping[str, Mapping[str, tuple]],
                   scale: Callable[[str, tuple], float], seed: int,
                   device: torch.device) -> Dict[str, Dict]:
    """{layer: {leaf: tensor}} of the shapes ``layout`` gives, made on
    ``device`` in one draw: uniform in +-1 in layout order, each leaf
    times ``scale(leaf, shape)``."""
    sizes = [math.prod(s) for leaves in layout.values()
             for s in leaves.values()]
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    parts = iter(torch.split(u, sizes))
    return {layer: {leaf: next(parts).view(shape) * scale(leaf, shape)
                    for leaf, shape in leaves.items()}
            for layer, leaves in layout.items()}


def audio(gen: torch.Generator, n: int, sr: int, device: torch.device,
          partials: int = 6) -> torch.Tensor:
    """[n, 2] float32 audio on ``device``."""
    r = torch.rand((partials, 6), generator=gen, device=device,
                   dtype=torch.float64)
    f = 55.0 * 2.0 ** (6.0 * r[:, 0])           # Hz
    amp = 0.05 + 0.25 * r[:, 1]
    pan = r[:, 2]
    swell = 0.05 + 0.5 * r[:, 3]                # Hz
    ph = 2 * math.pi * r[:, 4:6]
    t = torch.arange(n, device=device, dtype=torch.float64) / sr
    x = 0.02 * torch.randn((n, 2), generator=gen, device=device,
                           dtype=torch.float64)
    for k in range(partials):
        s = torch.sin(2 * math.pi * f[k] * t + ph[k, 0]) * (
            0.6 + 0.4 * torch.sin(2 * math.pi * swell[k] * t + ph[k, 1]))
        x[:, 0] += amp[k] * pan[k] * s
        x[:, 1] += amp[k] * (1 - pan[k]) * s
    return (x * (0.9 / max(1.0, float(x.abs().max())))).to(torch.float32)


def lengths_s(spec: Mapping) -> List[float]:
    """A mix's request lengths in seconds: ``count`` values from ``min`` to
    ``max``, evenly spaced (``linear``) or evenly in the logarithm
    (``log``), the same for every seed."""
    lo, hi, n = spec["min"], spec["max"], spec["count"]
    if n == 1:
        return [float(hi)]
    if spec["spacing"] == "linear":
        return [lo + (hi - lo) * i / (n - 1) for i in range(n)]
    return [lo * (hi / lo) ** (i / (n - 1)) for i in range(n)]


def songs(lengths: Sequence[float], sr: int, seed: int,
          device: torch.device) -> List[np.ndarray]:
    """One seeded [frames, 2] float32 host array a length: made on the
    device as one signal and cut."""
    gen = torch.Generator(device=device).manual_seed(seed ^ 0x5EED)
    n = [int(round(s * sr)) for s in lengths]
    x = audio(gen, sum(n), sr, device).cpu().numpy()
    return [np.ascontiguousarray(x[a:a + k])
            for a, k in zip(np.cumsum([0] + n[:-1]), n)]


def order(n: int, seed: int) -> List[int]:
    """The seeded order in which a pool of ``n`` requests cycles."""
    return [int(i) for i in np.random.default_rng(seed).permutation(n)]
