"""Elementwise and cropping primitives over [batch, width, channels] tensors.

PyTorch counterparts of ``waveunet_tpu/ops/primitives.py`` (the reference's
``Utils.py`` crop ``:104``, crop_and_concat ``:11``, LeakyReLU ``:79``,
AudioClip ``:82``, pad_freqs ``:44``).
"""

from __future__ import annotations

import torch


def leaky_relu(x: torch.Tensor, alpha: float = 0.2) -> torch.Tensor:
    """max(alpha*x, x)."""
    return torch.maximum(alpha * x, x)


def audio_clip(x: torch.Tensor, training: bool) -> torch.Tensor:
    """Identity when training, clip to [-1, 1] at inference."""
    if training:
        return x
    return torch.clamp(x, -1.0, 1.0)


def crop(x: torch.Tensor, target_len: int) -> torch.Tensor:
    """Centre-crop along width (dim 1).

    An odd difference crops one more sample from the end (diff // 2 at the
    start, diff - diff // 2 at the end), as the reference does.
    """
    diff = x.shape[1] - target_len
    if diff < 0:
        raise ValueError(f"cannot crop {x.shape[1]} to larger {target_len}")
    if diff == 0:
        return x
    start = diff // 2
    return x[:, start:start + target_len, :]


def crop_and_concat(skip: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Centre-crop ``skip`` to x's width, then concat(skip, x) on channels."""
    return torch.cat([crop(skip, x.shape[1]), x], dim=2)


def pad_freqs(x: torch.Tensor, target_freqs: int, axis: int = 1,
              value: float = 0.0) -> torch.Tensor:
    """Pad the frequency axis up to ``target_freqs`` with ``value``: an
    even difference symmetrically, an odd one with the extra bin at the end
    (the reference's ``Utils.py:44-77``)."""
    diff = target_freqs - x.shape[axis]
    if diff < 0:
        raise ValueError("target smaller than input freq axis")
    if diff == 0:
        return x
    lo, hi = diff // 2, diff - diff // 2
    pads = [0, 0] * x.dim()
    # F.pad lists (lo, hi) pairs from the last dim backwards
    j = 2 * (x.dim() - 1 - (axis % x.dim()))
    pads[j], pads[j + 1] = lo, hi
    return torch.nn.functional.pad(x, pads, mode="constant", value=value)
