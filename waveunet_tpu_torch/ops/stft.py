"""STFT / iSTFT with TF-compatible semantics, plus Griffin-Lim, in PyTorch.

Counterpart of ``waveunet_tpu/ops/stft.py``: frame 1024, hop 768, periodic
Hann, no centring (the tail that fills no frame is dropped), and the
least-squares synthesis window of TF's ``inverse_stft_window_fn``:

  frames   = 1 + (N - frame_len) // hop
  X[f]     = rfft(hann_periodic * x[f*hop : f*hop+frame_len])
  istft    = overlap-add of irfft(X) * w_syn,  w_syn = w / sum_k w^2[n - k*hop]

Framing and overlap-add use the JAX package's strip form (hop-aligned blocks,
no gather or scatter). The FFTs are ``torch.fft`` (cuFFT on the card). The
windows are made once per device and cached, so a CUDA-graph capture of a
forward that calls these functions copies nothing from the host.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from waveunet_tpu_torch.device import DeviceLike, resolve_device
from waveunet_tpu_torch.ops.shapes import STFT_FRAME_LEN as FRAME_LEN
from waveunet_tpu_torch.ops.shapes import STFT_HOP as HOP

_WINDOWS: Dict[Tuple, torch.Tensor] = {}


def _hann_np(n: int) -> np.ndarray:
    k = np.arange(n)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)


def _synthesis_window_np(frame_len: int, hop: int) -> np.ndarray:
    """TF ``inverse_stft_window_fn``: the analysis window divided by the
    sum of its squared overlaps at period ``hop``."""
    k = np.arange(frame_len)
    w = _hann_np(frame_len)
    denom = np.zeros(frame_len)
    max_shift = frame_len // hop + 1
    for m in range(-max_shift, max_shift + 1):
        idx = k - m * hop
        ok = (idx >= 0) & (idx < frame_len)
        denom[ok] += w[idx[ok]] ** 2
    return np.divide(w, denom, out=np.zeros_like(w), where=denom > 1e-30)


def _window(kind: str, frame_len: int, hop: int, device: torch.device,
            dtype: torch.dtype) -> torch.Tensor:
    key = (kind, frame_len, hop, str(device), dtype)
    w = _WINDOWS.get(key)
    if w is None:
        w_np = (_hann_np(frame_len) if kind == "hann"
                else _synthesis_window_np(frame_len, hop))
        w = torch.as_tensor(w_np.astype(np.float32), device=device).to(dtype)
        _WINDOWS[key] = w
    return w


def hann_periodic(n: int, device: DeviceLike = "cpu",
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Periodic Hann window (TF's default for the STFT)."""
    return _window("hann", n, 0, torch.device(device), dtype)


def synthesis_window(frame_len: int = FRAME_LEN, hop: int = HOP,
                     device: DeviceLike = "cpu",
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return _window("synthesis", frame_len, hop, torch.device(device), dtype)


def num_frames(n_samples: int, frame_len: int = FRAME_LEN,
               hop: int = HOP) -> int:
    if n_samples < frame_len:
        return 0
    return 1 + (n_samples - frame_len) // hop


def frame_signal(x: torch.Tensor, frame_len: int = FRAME_LEN,
                 hop: int = HOP) -> torch.Tensor:
    """[..., N] -> [..., F, frame_len] of hop-strided frames: frame f is the
    concatenation of ``ceil(frame_len / hop)`` consecutive hop blocks
    starting at block f."""
    f = num_frames(x.shape[-1], frame_len, hop)
    if f == 0:
        return x.new_zeros(x.shape[:-1] + (0, frame_len))
    s_count = -(-frame_len // hop)
    pad_to = hop * (f + s_count - 1)
    if x.shape[-1] < pad_to:
        x = F.pad(x, (0, pad_to - x.shape[-1]))
    blocks = x[..., :pad_to].reshape(x.shape[:-1] + (f + s_count - 1, hop))
    strips = [blocks[..., s:s + f, :min(hop, frame_len - s * hop)]
              for s in range(s_count)]
    return torch.cat(strips, dim=-1) if len(strips) > 1 else strips[0]


def stft(x: torch.Tensor, frame_len: int = FRAME_LEN, hop: int = HOP,
         fft_len: Optional[int] = None) -> torch.Tensor:
    """[..., N] real -> [..., F, fft_len // 2 + 1] complex."""
    frames = frame_signal(x, frame_len, hop)
    w = _window("hann", frame_len, 0, frames.device, frames.dtype)
    return torch.fft.rfft(frames * w, n=fft_len or frame_len, dim=-1)


def stft_magnitude(x: torch.Tensor, frame_len: int = FRAME_LEN,
                   hop: int = HOP) -> torch.Tensor:
    """|stft(x)|: the target of U7a's L1 magnitude loss."""
    return stft(x, frame_len, hop).abs()


def istft(spec: torch.Tensor, frame_len: int = FRAME_LEN, hop: int = HOP,
          fft_len: Optional[int] = None) -> torch.Tensor:
    """[..., F, bins] complex -> [..., hop*(F-1)+frame_len] real, by
    overlap-add in strips: strip s of every frame lands at offset s*hop of
    its hop block, and only strips of different s ever overlap."""
    frames = torch.fft.irfft(spec, n=fft_len or frame_len,
                             dim=-1)[..., :frame_len]
    frames = frames * _window("synthesis", frame_len, hop, frames.device,
                              frames.dtype)
    f = spec.shape[-2]
    out_len = hop * (f - 1) + frame_len
    s_count = -(-frame_len // hop)
    lead = frames.shape[:-2]
    out = frames.new_zeros(lead + (out_len,))
    for s in range(s_count):
        w = min(hop, frame_len - s * hop)
        strip = frames[..., s * hop:s * hop + w]
        if w < hop:
            strip = F.pad(strip, (0, hop - w))
        flat = strip.reshape(lead + (f * hop,))
        end = s * hop + f * hop
        if end > out_len:
            flat = flat[..., :out_len - s * hop]
            end = out_len
        out = out + F.pad(flat, (s * hop, out_len - end))
    return out


def griffin_lim(magnitude: np.ndarray, frame_len: int = FRAME_LEN,
                hop: int = HOP, iterations: int = 10,
                init_phase: Optional[np.ndarray] = None,
                length: Optional[int] = None, seed: int = 0,
                device: DeviceLike = None) -> np.ndarray:
    """Griffin-Lim phase recovery from a magnitude spectrogram [F, bins]
    (the reference's ``Utils.py:148-173``), on ``device`` (the card unless
    ``"cpu"``); returns host audio."""
    dev = resolve_device(device)
    mag = torch.as_tensor(np.asarray(magnitude, np.float32), device=dev)
    if init_phase is None:
        init_phase = np.random.default_rng(seed).uniform(
            -np.pi, np.pi, magnitude.shape)
    phase = torch.as_tensor(np.asarray(init_phase, np.float32), device=dev)
    spec = mag * torch.exp(1j * phase)
    for _ in range(max(iterations - 1, 0)):
        re = stft(istft(spec, frame_len, hop), frame_len, hop)
        f = min(re.shape[-2], mag.shape[-2])
        spec = mag[..., :f, :] * torch.exp(1j * torch.angle(re[..., :f, :]))
    audio = istft(spec, frame_len, hop).cpu().numpy()
    if length is not None:
        if audio.shape[-1] < length:
            audio = np.pad(audio, [(0, length - audio.shape[-1])])
        audio = audio[..., :length]
    return audio
