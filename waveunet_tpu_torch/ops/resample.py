"""Polyphase sample-rate conversion, on the host and on the device.

A copy of ``waveunet_tpu/ops/resample.py``: a Kaiser-windowed sinc
polyphase filter whose parameters (64 zero crossings, beta=14.77, rolloff
.9475) mirror resampy's "kaiser_best", with exact group-delay compensation.
The host path (``resample``) applies it with ``scipy.signal.upfirdn``; the
JAX package may take a native C++ kernel with the same taps instead, and
results agree to float32 rounding. The device path (``resample_device``,
the counterpart of ``resample_jnp``) computes the same sums in fp32 with
PyTorch convolutions in polyphase form.
"""

from __future__ import annotations

import math
from fractions import Fraction
from functools import lru_cache

import numpy as np
import torch
from scipy.signal import upfirdn

from waveunet_tpu_torch.device import DeviceLike, resolve_device
from waveunet_tpu_torch.ops.conv import tf32_scope
from waveunet_tpu_torch.tracing import spanned


_ZEROS = 64          # zero crossings per side (resampy kaiser_best: 64)
_BETA = 14.769656459379492
_ROLLOFF = 0.9475937167399596


@lru_cache(maxsize=32)
def _kaiser_filter(p: int, q: int):
    """Lowpass prototype on the up-by-p grid. DC gain p (interpolation gain)."""
    cutoff = _ROLLOFF / max(1.0, q / p)  # relative to output Nyquist on up-grid
    half = int(math.ceil(_ZEROS * p / cutoff))
    n = np.arange(-half, half + 1, dtype=np.float64)
    taps = (cutoff / p) * np.sinc((cutoff / p) * n)
    taps *= np.kaiser(len(n), _BETA)
    taps *= p / taps.sum()  # exact DC gain p so unit signals stay unit
    taps.flags.writeable = False  # shared by every caller of the cache
    return taps, half


def _resample_plan(n_in: int, orig_sr: int, new_sr: int):
    """(p, q, taps, half, c, start, n_out): up by p, down by q; ``c`` zero
    input samples prepended so that the group delay (half taps on the
    up-grid) lands on an exact output stride, (half + c*p) % q == 0, and
    output j is sample ``start + j`` of the filtered, decimated signal."""
    frac = Fraction(new_sr, orig_sr)
    p, q = frac.numerator, frac.denominator
    taps, half = _kaiser_filter(p, q)
    n_out = int(math.ceil(n_in * new_sr / orig_sr))
    c = (-half * pow(p, -1, q)) % q if q > 1 else 0
    start = (half + c * p) // q
    return p, q, taps, half, c, start, n_out


def _check_rates(orig_sr: int, new_sr: int) -> None:
    if orig_sr <= 0 or new_sr <= 0:
        # negative rates otherwise sail through Fraction() and return
        # garbage; zero divides inside the filter design
        raise ValueError(f"sample rates must be positive, got "
                         f"{orig_sr} -> {new_sr}")


@spanned("resample")
def resample(audio: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Resample (frames[, channels]) audio; output length ceil(n*new/orig)."""
    _check_rates(orig_sr, new_sr)
    if orig_sr == new_sr:
        return np.asarray(audio, np.float32)

    x = np.asarray(audio, np.float64)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    p, q, taps, half, c, start, n_out = _resample_plan(x.shape[0], orig_sr,
                                                       new_sr)
    if c:
        x = np.concatenate([np.zeros((c, x.shape[1])), x], axis=0)
    # Zero-pad the tail so upfirdn produces the full output range.
    tail = int(math.ceil((half + q) / p)) + 1
    x = np.concatenate([x, np.zeros((tail, x.shape[1]))], axis=0)
    y = upfirdn(taps, x, up=p, down=q, axis=0)
    out = y[start:start + n_out].astype(np.float32)
    return out[:, 0] if squeeze else out


@spanned("resample")
def resample_device(audio, orig_sr: int, new_sr: int,
                    device: DeviceLike = None) -> torch.Tensor:
    """Resample (frames[, channels]) audio on the device; the same taps,
    plan and output as ``resample``, in fp32 (TF32 off).

    The JAX package writes the up-by-p stage as an input dilation of one
    convolution. Stuffing p - 1 zeros between samples would multiply the
    input by p (147 for 48,000 -> 44,100), so this is the polyphase form:
    output ``m = r + p*t`` reads only taps ``taps[phi_r::p]`` (``phi_r`` =
    (start + r)*q mod p) against input samples ``b_r + q*t - j`` (``b_r`` =
    (start + r)*q // p), one stride-q convolution a phase r, written into
    the output at stride p. ``audio`` is a tensor (its device is used) or
    an array (moved to ``device``, the card by default); the result is a
    float32 tensor on that device.
    """
    _check_rates(orig_sr, new_sr)
    if isinstance(audio, torch.Tensor):
        x = audio.to(torch.float32)
    else:
        x = torch.as_tensor(np.asarray(audio, np.float32),
                            device=resolve_device(device))
    if orig_sr == new_sr:
        return x
    squeeze = x.dim() == 1
    if squeeze:
        x = x[:, None]
    n_in, n_ch = x.shape
    p, q, taps, half, c, start, n_out = _resample_plan(n_in, orig_sr, new_sr)
    phases = []  # (r, offset of its reversed sub-filter, length, lo, n_r)
    filters, off = [], 0
    for r in range(min(p, n_out)):
        base, phi = divmod((start + r) * q, p)
        # conv1d correlates, out[t] = sum_k g[k] x'[lo + q*t + k], with g
        # the sub-filter reversed and lo = base - (len - 1), where x' is x
        # behind c zeros: lo is lowered by c to index x itself
        g = taps[phi::p][::-1]
        filters.append(g)
        n_r = -(-(n_out - r) // p)
        phases.append((r, off, len(g), base - (len(g) - 1) - c, n_r))
        off += len(g)
    left = max(0, -min(ph[3] for ph in phases))
    right = max(0, max(lo + q * (n_r - 1) + k
                       for _, _, k, lo, n_r in phases) - n_in)
    xp = torch.nn.functional.pad(x.t()[:, None, :], (left, right))  # [C,1,L]
    bank = torch.as_tensor(np.concatenate(filters).astype(np.float32),
                           device=x.device)  # every sub-filter, one copy
    out = x.new_zeros((n_ch, -(-n_out // p) * p))
    rows = out.view(n_ch, -1, p)  # output r + p*t at rows[:, t, r]
    with tf32_scope(False):
        for r, at, k, lo, n_r in phases:
            seg = xp[..., left + lo:left + lo + q * (n_r - 1) + k]
            rows[:, :n_r, r] = torch.nn.functional.conv1d(
                seg, bank[at:at + k][None, None], stride=q)[:, 0]
    y = out[:, :n_out].t()
    return y[:, 0] if squeeze else y.contiguous()
