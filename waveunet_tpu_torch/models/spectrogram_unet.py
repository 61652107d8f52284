"""Spectrogram U-Net (U7/U7a, Jansson et al. 2017), inference, in PyTorch.

Counterpart of ``waveunet_tpu/models/spectrogram_unet.py`` over the same
flat parameter and state dicts (``"<src>/down_i"``, ``"<src>/down_i_bn"``,
``"<src>/up_i"``, ``"<src>/up_i_bn"``, ``"<src>/mask"``; TF layouts), so
``compat/params.py`` carries them across unchanged:

  * STFT front end: frame 1024, hop 768, periodic Hann; log1p magnitude with
    the last frequency bin dropped (512 bins);
  * one 2-D U-Net per source: ``num_layers`` x [conv2d 5x5 stride 2 SAME +
    centre-only batch norm + LeakyReLU], then ``num_layers - 1`` x
    [conv2d_transpose 5x5 stride 2 + batch norm + ReLU + skip concat], then
    a sigmoid mask from a last transposed conv, its dropped bin re-padded
    with 0.5;
  * source = iSTFT(mask * mixture spectrum), or the masked magnitudes with
    ``return_spectrogram``.

Batch norm uses the moving statistics of ``state`` (eps 0.001, no scale).
The 2-D convs run with cuDNN's deterministic algorithms, so a song
separates to the same bits every time. Inference only: training (batch
statistics, dropout) and bf16 compute raise.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional, Tuple

import torch

from waveunet_tpu_torch.config import Config
from waveunet_tpu_torch.device import DeviceLike, resolve_device
from waveunet_tpu_torch.ops.conv import (conv2d, conv2d_init,
                                         conv2d_transpose, precision_scope)
from waveunet_tpu_torch.ops.primitives import leaky_relu, pad_freqs
from waveunet_tpu_torch.ops.stft import istft, stft

BN_EPS = 0.001

Tree = Dict[str, Dict[str, torch.Tensor]]


def init_spectrogram_unet(generator: torch.Generator, cfg: Config,
                          device: DeviceLike = None) -> Tuple[Tree, Tree]:
    """(params, state) in the JAX package's shapes and key order:
    glorot-uniform kernels, zero biases and betas, moving mean 0 and
    variance 1. ``generator`` is a CPU ``torch.Generator``."""
    if not cfg.mono_downmix or cfg.num_sources != 2:
        raise NotImplementedError(
            "spectrogram U-Net supports mono 2-source configs only "
            "(the reference asserts it, UnetSpectrogramSeparator.py:24-25)")
    dev = resolve_device(device)
    params: Tree = {}
    state: Tree = {}
    L = cfg.num_layers
    f0 = cfg.num_initial_filters

    def bn(key, ch):
        params[key] = {"beta": torch.zeros((ch,), device=dev)}
        state[key] = {"mean": torch.zeros((ch,), device=dev),
                      "var": torch.ones((ch,), device=dev)}

    for s in cfg.source_names:
        in_ch = 1
        for i in range(L):
            out_ch = f0 * 2 ** i
            params[f"{s}/down_{i}"] = conv2d_init(generator, (5, 5), in_ch,
                                                  out_ch, dev)
            bn(f"{s}/down_{i}_bn", out_ch)
            in_ch = out_ch
        for i in range(L - 1):
            out_ch = f0 * 2 ** (L - i - 2)
            params[f"{s}/up_{i}"] = conv2d_init(generator, (5, 5), in_ch,
                                                out_ch, dev, transpose=True)
            bn(f"{s}/up_{i}_bn", out_ch)
            in_ch = 2 * out_ch  # concat with the skip of the same width
        params[f"{s}/mask"] = conv2d_init(generator, (5, 5), in_ch, 1, dev,
                                          transpose=True)
    return params, state


@contextlib.contextmanager
def deterministic_cudnn() -> Iterator[None]:
    """cuDNN may compute a transposed conv (its backward-data pass) with
    atomic adds, whose order varies from run to run; the separation of a
    song must not. Restores the caller's setting after the block."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def _bn(x: torch.Tensor, beta: torch.Tensor,
        stats: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Centre-only batch norm with the moving statistics."""
    return (x - stats["mean"]) * torch.rsqrt(stats["var"] + BN_EPS) + beta


@torch.no_grad()
def apply_spectrogram_unet(params: Tree, cfg: Config, mix: torch.Tensor,
                           training: bool = False,
                           state: Optional[Tree] = None,
                           return_spectrogram: bool = False
                           ) -> Tuple[Dict[str, torch.Tensor], Tree]:
    """mix ``[B, N, 1]`` -> ({source: audio ``[B, M, 1]``} or magnitudes
    ``[B, F, 513]``), state (returned unchanged)."""
    if training:
        raise NotImplementedError(
            "waveunet_tpu_torch serves inference only; training is not ported")
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype={cfg.compute_dtype!r}: the port computes the "
            f"spectrogram U-Net in float32 only")
    if mix.shape[2] != 1:
        raise ValueError("the spectrogram model is mono-only")
    state = state or {}
    L = cfg.num_layers
    with precision_scope(cfg.conv_precision), deterministic_cudnn():
        spec = stft(mix[..., 0])                          # [B, F, 513]
        mix_mag = spec.abs()
        x0 = torch.log1p(mix_mag)[..., None][:, :, :-1, :]  # [B, F, 512, 1]
        masks, mags = {}, {}
        for s in cfg.source_names:
            cur = x0
            skips = []
            for i in range(L):
                if cur.shape[1] % 2 or cur.shape[2] % 2:
                    raise ValueError(f"spectrogram dims must halve cleanly, "
                                     f"got {tuple(cur.shape)}")
                cur = conv2d(cur, params[f"{s}/down_{i}"], stride=(2, 2))
                cur = leaky_relu(_bn(cur, params[f"{s}/down_{i}_bn"]["beta"],
                                     state[f"{s}/down_{i}_bn"]))
                if i < L - 1:
                    skips.append(cur)
            for i in range(L - 1):
                cur = conv2d_transpose(cur, params[f"{s}/up_{i}"],
                                       stride=(2, 2))
                cur = torch.relu(_bn(cur, params[f"{s}/up_{i}_bn"]["beta"],
                                     state[f"{s}/up_{i}_bn"]))
                cur = torch.cat([skips[-i - 1], cur], dim=3)
            mask = torch.sigmoid(conv2d_transpose(cur, params[f"{s}/mask"],
                                                  stride=(2, 2)))
            masks[s] = pad_freqs(mask, mix_mag.shape[2], axis=2,
                                 value=0.5)[..., 0]
            mags[s] = mix_mag * masks[s]
        if return_spectrogram:
            return mags, state
        # mask * spec is the reference's mag_s * exp(i angle(spec))
        return {s: istft(masks[s] * spec)[..., None]
                for s in cfg.source_names}, state
