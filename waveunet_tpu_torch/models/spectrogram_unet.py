"""Spectrogram U-Net (U7/U7a, Jansson et al. 2017), inference and training, in PyTorch.

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

Batch norm (eps 0.001, centre only) uses the moving statistics of
``state`` at inference; training normalises by the batch's statistics and
moves the state's by 0.999, threaded through as the JAX package does, and
applies dropout 0.5 on the first three up layers from an explicit
``torch.Generator``. On a mesh of several ranks the batch is the global
batch: its statistics come through a differentiable all-reduce and each
rank keeps its rows of the global dropout masks. The 2-D convs run with cuDNN's deterministic
algorithms, so a song separates to the same bits every time.

``Config.compute_dtype="bfloat16"`` rounds both operands of every down, up
and mask conv to bf16 at inference and sums them in fp32
(``ops/conv.py::conv2d``); STFT, iSTFT, log1p, batch norm, the sigmoid and
``pad_freqs`` stay fp32. Training computes in fp32 whatever it says, as the
JAX package does.
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
from waveunet_tpu_torch.parallel.mesh import Mesh, all_reduce_sum

BN_EPS = 0.001
BN_MOMENTUM = 0.999

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


def _bn_train(x: torch.Tensor, beta: torch.Tensor,
              stats: Dict[str, torch.Tensor], mesh: Optional[Mesh] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Centre-only batch norm by the batch's statistics (population
    variance); returns (y, the moving statistics moved by 0.999), the new
    statistics carrying no gradient.

    On a mesh of several ranks, ``x`` is this rank's rows and the
    statistics are the whole sharded batch's, as ``jnp.mean``/``jnp.var``
    take them under a batch sharding: the mean is the all-reduced sum over
    the global count, the variance a second pass, the all-reduced sum of
    squared deviations from that mean over the same count. Every rank then
    moves the same statistics."""
    if mesh is None or mesh.size == 1:
        mean = x.mean(dim=(0, 1, 2))
        var = x.var(dim=(0, 1, 2), unbiased=False)
    else:
        count = x.shape[0] * x.shape[1] * x.shape[2] * mesh.size
        mean = all_reduce_sum(x.sum(dim=(0, 1, 2)), mesh) / count
        var = all_reduce_sum(torch.square(x - mean).sum(dim=(0, 1, 2)),
                             mesh) / count
    new = {"mean": BN_MOMENTUM * stats["mean"]
           + (1 - BN_MOMENTUM) * mean.detach(),
           "var": BN_MOMENTUM * stats["var"]
           + (1 - BN_MOMENTUM) * var.detach()}
    return (x - mean) * torch.rsqrt(var + BN_EPS) + beta, new


def dropout(x: torch.Tensor, generator: torch.Generator,
            mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Keep each value with probability 0.5, scaled by 2; zero the rest.
    The mask is drawn on the generator's device. On a mesh of several
    ranks each rank draws the mask of the whole global batch, as one
    process would, and keeps its own rows."""
    shape = tuple(x.shape)
    rows = slice(None)
    if mesh is not None and mesh.size > 1:
        n = shape[0]
        shape = (n * mesh.size,) + shape[1:]
        rows = slice(mesh.rank * n, (mesh.rank + 1) * n)
    keep = torch.rand(shape, generator=generator,
                      device=generator.device)[rows].to(x.device) < 0.5
    return torch.where(keep, x / 0.5, 0.0)


def apply_spectrogram_unet(params: Tree, cfg: Config, mix: torch.Tensor,
                           training: bool = False,
                           state: Optional[Tree] = None,
                           return_spectrogram: bool = False,
                           generator: Optional[torch.Generator] = None,
                           mesh: Optional[Mesh] = None
                           ) -> Tuple[Dict[str, torch.Tensor], Tree]:
    """mix ``[B, N, 1]`` -> ({source: audio ``[B, M, 1]``} or magnitudes
    ``[B, F, 513]``), new state.

    ``training=False`` runs under ``torch.no_grad()`` with the moving
    statistics and returns ``state`` unchanged. ``training=True`` is
    differentiable, normalises by batch statistics, returns the moved
    statistics, and drops half of the first three up layers' values (kept
    ones scaled by 2) with masks drawn from ``generator`` (seed 0 on mix's
    device when None). The masks cannot match ``jax.random``'s. With a
    ``mesh`` of several ranks (training only), ``mix`` is this rank's rows
    of the global batch: the batch statistics and the dropout masks are
    the global batch's (``_bn_train``, ``dropout``).
    """
    if mix.shape[2] != 1:
        raise ValueError("the spectrogram model is mono-only")
    state = state or {}
    if training and generator is None:
        generator = torch.Generator(mix.device).manual_seed(0)
    with (contextlib.nullcontext() if training else torch.no_grad()), \
            precision_scope(cfg.conv_precision), deterministic_cudnn():
        return _forward(params, cfg, mix, training, state, return_spectrogram,
                        generator, mesh)


def _forward(params: Tree, cfg: Config, mix: torch.Tensor, training: bool,
             state: Tree, return_spectrogram: bool,
             generator: Optional[torch.Generator], mesh: Optional[Mesh]
             ) -> Tuple[Dict[str, torch.Tensor], Tree]:
    L = cfg.num_layers
    new_state: Tree = {}
    # bf16 conv operands at inference only (module docstring)
    cdtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
              and not training else None)

    def norm(key, x):
        if not training:
            return _bn(x, params[key]["beta"], state[key])
        y, new_state[key] = _bn_train(x, params[key]["beta"], state[key],
                                      mesh)
        return y

    spec = stft(mix[..., 0])                              # [B, F, 513]
    mix_mag = spec.abs()
    x0 = torch.log1p(mix_mag)[..., None][:, :, :-1, :]   # [B, F, 512, 1]
    masks, mags = {}, {}
    for s in cfg.source_names:
        cur = x0
        skips = []
        for i in range(L):
            if cur.shape[1] % 2 or cur.shape[2] % 2:
                raise ValueError(f"spectrogram dims must halve cleanly, "
                                 f"got {tuple(cur.shape)}")
            cur = conv2d(cur, params[f"{s}/down_{i}"], stride=(2, 2),
                         compute_dtype=cdtype)
            cur = leaky_relu(norm(f"{s}/down_{i}_bn", cur))
            if i < L - 1:
                skips.append(cur)
        for i in range(L - 1):
            cur = conv2d_transpose(cur, params[f"{s}/up_{i}"], stride=(2, 2),
                                   compute_dtype=cdtype)
            cur = torch.relu(norm(f"{s}/up_{i}_bn", cur))
            cur = torch.cat([skips[-i - 1], cur], dim=3)
            if i < 3 and training:  # dropout(0.5) on the first 3 up layers
                cur = dropout(cur, generator, mesh)
        mask = torch.sigmoid(conv2d_transpose(cur, params[f"{s}/mask"],
                                              stride=(2, 2),
                                              compute_dtype=cdtype))
        masks[s] = pad_freqs(mask, mix_mag.shape[2], axis=2,
                             value=0.5)[..., 0]
        mags[s] = mix_mag * masks[s]
    if not training:
        new_state = state
    if return_spectrogram:
        return mags, new_state
    # mask * spec is the reference's mag_s * exp(i angle(spec))
    return {s: istft(masks[s] * spec)[..., None]
            for s in cfg.source_names}, new_state
