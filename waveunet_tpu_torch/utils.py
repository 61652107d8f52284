"""The reference's ``Utils`` names, mapped onto the port.

Counterpart of ``waveunet_tpu/utils.py``: scripts written against the
reference's flat ``Utils`` module find its helpers here under their
familiar names, implemented by the port's ops:

  crop, crop_and_concat, LeakyReLU, AudioClip, pad_freqs   -> ops.primitives
  resample, load                                           -> ops.resample / data.audio_io
  spectrogramToAudioFile (Griffin-Lim, or one iSTFT)       -> ops.stft
  getNumParams                                             -> train.loop.num_params
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from waveunet_tpu_torch.data.audio_io import load  # noqa: F401
from waveunet_tpu_torch.device import DeviceLike, resolve_device
from waveunet_tpu_torch.ops.primitives import (  # noqa: F401
    crop_and_concat,
    pad_freqs,
)
from waveunet_tpu_torch.ops.primitives import audio_clip as AudioClip  # noqa: F401
from waveunet_tpu_torch.ops.primitives import crop as _crop
from waveunet_tpu_torch.ops.primitives import leaky_relu as LeakyReLU  # noqa: F401
from waveunet_tpu_torch.ops.resample import resample  # noqa: F401
from waveunet_tpu_torch.ops.stft import griffin_lim, istft
from waveunet_tpu_torch.train.loop import num_params as getNumParams  # noqa: F401


def crop(tensor, target_shape, match_feature_dim=True):
    """Centre-crop along the width axis; takes a full target shape, as the
    reference does, or a plain target length."""
    target_len = (target_shape[1] if hasattr(target_shape, "__len__")
                  else int(target_shape))
    return _crop(tensor, target_len)


def spectrogramToAudioFile(magnitude: np.ndarray, fftWindowSize: int = 1024,
                           hopSize: int = 768, phaseIterations: int = 10,
                           phase: Optional[np.ndarray] = None,
                           length: Optional[int] = None,
                           device: DeviceLike = None) -> np.ndarray:
    """Magnitude (and an optional initial phase) -> audio by Griffin-Lim,
    or by one iSTFT of magnitude and phase with ``phaseIterations=0``.

    Takes both orientations: the reference's (librosa's) ``[bins, frames]``
    and the port's ``[frames, bins]``, told apart by which axis equals
    ``fftWindowSize // 2 + 1``; a square spectrogram is read as
    ``[frames, bins]`` with a warning. Runs on ``device`` (the card unless
    ``"cpu"``) and returns host audio."""
    bins = fftWindowSize // 2 + 1
    if magnitude.shape[0] == bins and magnitude.shape[-1] != bins:
        magnitude = np.asarray(magnitude).T
        phase = None if phase is None else np.asarray(phase).T
    elif magnitude.shape[-1] != bins:
        raise ValueError(
            f"magnitude shape {magnitude.shape} has no axis of "
            f"{bins} = fftWindowSize//2+1 frequency bins")
    elif magnitude.shape[0] == bins:
        warnings.warn(
            f"square {magnitude.shape} spectrogram is ambiguous; assuming "
            f"[frames, bins] — transpose explicitly if it is the reference's "
            f"[bins, frames] orientation", stacklevel=2)
    if phase is not None and phaseIterations == 0:
        spec = torch.as_tensor(magnitude * np.exp(1j * phase),
                               dtype=torch.complex64,
                               device=resolve_device(device))
        audio = istft(spec, fftWindowSize, hopSize).cpu().numpy()
        if length is not None:
            audio = audio[..., :length]
        return audio
    return griffin_lim(magnitude, fftWindowSize, hopSize,
                       iterations=phaseIterations, init_phase=phase,
                       length=length, device=device)
