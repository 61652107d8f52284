"""Polyphase sample-rate conversion, on the host and on the device.

A copy of ``waveunet_tpu/ops/resample.py``: a Kaiser-windowed sinc
polyphase filter whose parameters (64 zero crossings, beta=14.77, rolloff
.9475) mirror resampy's "kaiser_best", with exact group-delay compensation.
The host path (``resample``) applies it with ``scipy.signal.upfirdn`` in
float64; the JAX package may take a native C++ kernel with the same taps
instead, and results agree to float32 rounding. The device path
(``resample_device``, the counterpart of ``resample_jnp``) computes the
same sums in float64 too, from fp32 or float64 audio: on a CUDA tensor in
the hand-written kernel ``ops/kernels/csrc/resample_poly.cu``
(``ops/kernels/resample_poly.py``), on any other device in its plain,
differentiable PyTorch form (``resample_polyphase``), one stride-q
convolution a phase. Both round each sum to fp32 once, so they agree with
the host within one fp32 ulp. ``Separator.separate`` (``infer/engine.py``)
resamples a song at another rate on the card through the kernel when its
device is CUDA, and with ``resample`` otherwise.
"""

from __future__ import annotations

import math
from fractions import Fraction
from functools import lru_cache

import numpy as np
import torch
from scipy.signal import upfirdn

from waveunet_tpu_torch.device import DeviceLike, resolve_device
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


@lru_cache(maxsize=32)
def polyphase_bank(p: int, q: int):
    """(bank, L): every phase's sub-filter of the ``(p, q)`` filter,
    reversed, as the rows of a ``[p, kmax]`` float64 array zero-padded on
    the right, and L, the filter's length. Phase ``phi`` has the
    ``(L - 1 - phi) // p + 1`` taps ``bank[phi, i] = taps[phi + (K - 1 -
    i) * p]``: the tap for input sample ``base - K + 1 + i`` of an output
    whose up-grid index is ``base * p + phi``."""
    taps, _ = _kaiser_filter(p, q)
    L = len(taps)
    phi = np.arange(p)[:, None]
    k = (L - 1 - phi) // p + 1
    i = np.arange(int(k[0, 0]))[None, :]
    idx = phi + (k - 1 - i) * p
    bank = np.where(i < k, taps[np.clip(idx, 0, L - 1)], 0.0)
    bank.flags.writeable = False  # shared by every caller of the cache
    return bank, L


def resample_polyphase(x: torch.Tensor, orig_sr: int,
                       new_sr: int) -> torch.Tensor:
    """The plain version of the device resampler: [n, C] audio on any
    device to [n_out, C] float32, as ``resample`` plans it, the products
    and sums in float64, rounded to float32 once.

    Output ``m = r + p*t`` reads only the reversed sub-filter of phase
    ``phi_r`` = (start + r)*q mod p against input samples from ``b_r + q*t
    - (K - 1)`` up (``b_r`` = (start + r)*q // p, behind the plan's ``c``
    zeros): one stride-q convolution a phase r, written into the output at
    stride p. Stuffing p - 1 zeros between samples, as the JAX package's
    input-dilated convolution does, would multiply the input by p (147 for
    48,000 -> 44,100)."""
    n_in, n_ch = x.shape
    p, q, _, _, c, start, n_out = _resample_plan(n_in, orig_sr, new_sr)
    bank_np, L = polyphase_bank(p, q)
    phases = []  # (r, phi, K, lo, n_r)
    for r in range(min(p, n_out)):
        base, phi = divmod((start + r) * q, p)
        k = (L - 1 - phi) // p + 1
        n_r = -(-(n_out - r) // p)
        # conv1d correlates, out[t] = sum_i g[i] x'[lo + q*t + i]; lo is
        # lowered by c to index x itself
        phases.append((r, phi, k, base - (k - 1) - c, n_r))
    left = max(0, -min(ph[3] for ph in phases))
    right = max(0, max(lo + q * (n_r - 1) + k
                       for _, _, k, lo, n_r in phases) - n_in)
    xp = torch.nn.functional.pad(x.to(torch.float64).t()[:, None, :],
                                 (left, right))  # [C, 1, L]
    bank = torch.tensor(bank_np, device=x.device)
    out = xp.new_zeros((n_ch, -(-n_out // p) * p))
    rows = out.view(n_ch, -1, p)  # output r + p*t at rows[:, t, r]
    for r, phi, k, lo, n_r in phases:
        seg = xp[..., left + lo:left + lo + q * (n_r - 1) + k]
        rows[:, :n_r, r] = torch.nn.functional.conv1d(
            seg, bank[phi, :k][None, None], stride=q)[:, 0]
    return out[:, :n_out].t().to(torch.float32)


@spanned("resample")
def resample_device(audio, orig_sr: int, new_sr: int,
                    device: DeviceLike = None) -> torch.Tensor:
    """Resample (frames[, channels]) audio on the device; the same taps,
    plan and output as ``resample``, the sums in float64 from the audio as
    it comes when it is float64, else from it in fp32.

    On a CUDA tensor the kernel ``ops/kernels/resample_poly.py`` runs (or
    raises; it refuses an input that requires grad under grad mode, having
    no backward); on any other device its plain version,
    ``resample_polyphase``, which autograd differentiates. ``audio`` is a
    tensor (its device is used) or an array (moved to ``device``, the card
    by default); the result is a float32 tensor on that device.
    """
    _check_rates(orig_sr, new_sr)
    if not isinstance(audio, torch.Tensor):
        audio = torch.as_tensor(np.asarray(audio),
                                device=resolve_device(device))
    x = audio if audio.dtype == torch.float64 else audio.to(torch.float32)
    if orig_sr == new_sr:
        return x.to(torch.float32)
    squeeze = x.dim() == 1
    if squeeze:
        x = x[:, None]
    if x.device.type == "cuda":
        from waveunet_tpu_torch.ops.kernels.resample_poly import (
            resample_poly_cuda)
        y = resample_poly_cuda(x.contiguous(), orig_sr, new_sr)
    else:
        y = resample_polyphase(x, orig_sr, new_sr)
    return y[:, 0] if squeeze else y
