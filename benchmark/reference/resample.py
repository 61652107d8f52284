"""Kaiser-windowed sinc resampling, written from its definition.

The filter is resampy's "kaiser_best": a sinc low-pass with 64 zero
crossings a side, Kaiser window beta 14.769656459379492, cut-off at
0.9475937167399596 of the lower Nyquist rate, its taps scaled to a DC gain
of ``p``. For a rate change by ``p / q`` (in lowest terms), with ``g`` the
filter centred on 0 on the grid of ``p`` times the input rate,

    out[j] = sum_i x[i] * g[j*q - i*p],    j < ceil(n * p / q),

so output sample j sits at time j / new_rate, with no delay. Computed in
float64 on the input's device and returned as float32.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import torch
import torch.nn.functional as F

ZEROS = 64
BETA = 14.769656459379492
ROLLOFF = 0.9475937167399596


def kaiser_taps(p: int, q: int) -> np.ndarray:
    """g[-half .. half] on the up-by-p grid, DC gain p."""
    cutoff = ROLLOFF / max(1.0, q / p)
    half = int(math.ceil(ZEROS * p / cutoff))
    n = np.arange(-half, half + 1, dtype=np.float64)
    g = (cutoff / p) * np.sinc((cutoff / p) * n) * np.kaiser(2 * half + 1,
                                                            BETA)
    return g * (p / g.sum())


def resample(x: torch.Tensor, orig_sr: int, new_sr: int) -> torch.Tensor:
    """[n, C] audio (any float dtype) -> [ceil(n * new / orig), C] float32."""
    if orig_sr == new_sr:
        return x.to(torch.float32)
    fr = Fraction(new_sr, orig_sr)
    p, q = fr.numerator, fr.denominator
    g = torch.as_tensor(kaiser_taps(p, q), dtype=torch.float64,
                        device=x.device)
    half = (g.numel() - 1) // 2
    n, C = x.shape
    n_out = -(-n * p // q)
    xs = x.to(torch.float64).t()[:, None, :]  # [C, 1, n]
    out = torch.zeros((C, n_out), dtype=torch.float64, device=x.device)
    # output j = r + p*t reads out[r + p*t] = sum_m x[t*q - m] * g[p*m + r*q]:
    # one stride-q correlation a phase r with the sub-filter over those m
    for r in range(min(p, n_out)):
        m = np.arange(-(half + r * q) // p - 1, (half - r * q) // p + 2)
        m = m[np.abs(p * m + r * q) <= half]
        taps = g[torch.as_tensor(p * m + r * q + half, device=x.device)]
        n_t = -(-(n_out - r) // p)
        # sum_k taps_rev[k] * x[t*q - m_max + k], k = m_max - m
        lo = -int(m.max())
        span = q * (n_t - 1) + len(m)
        left = max(0, -lo)
        right = max(0, lo + span - n)
        seg = F.pad(xs, (left, right))[..., lo + left:lo + left + span]
        out[:, r::p] = F.conv1d(seg, taps.flip(0)[None, None], stride=q)[:, 0]
    return out.t().to(torch.float32)
