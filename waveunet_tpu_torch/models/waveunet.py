"""Time-domain Wave-U-Net separator, inference and training forward, in PyTorch.

Counterpart of ``waveunet_tpu/models/waveunet.py`` over the same flat
parameter dict (``down_i``, ``bottleneck``, ``interp_i``, ``up_i``,
``out_<src>``, each ``{"kernel", "bias"}`` or ``{"weights"}``, TF layouts), so
``compat/params.py`` moves weights between the two packages by renaming
nothing:

  * down path: ``num_layers`` x [conv(filter_size) + LeakyReLU -> skip ->
    x[:, ::2]], then the bottleneck conv + LeakyReLU;
  * up path: ``num_layers`` x [x2 upsample (learned or bilinear) ->
    crop-and-concat skip -> conv(merge_filter_size) + LeakyReLU];
  * concat with the (cropped) input, then the K=1 output convs with tanh or
    clip, direct or difference output.

At inference (``training=False``) every conv + LeakyReLU goes through
``ops/kernels/conv1d_fused.py`` and every learned interpolation through
``ops/kernels/interp.py``: on a CUDA device they launch the hand-written
kernels, on the CPU their plain versions run. The training forward
(``training=True``) is plain differentiable PyTorch (cuDNN convs under
autograd on the card): the kernels have no backward, and the JAX package
keeps its Pallas kernels out of training too.
Decimation is the strided view the kernel reads without a copy, as in the JAX
package's ``use_pallas`` path; same-padded presets pad explicitly before the
same kernel. The K=1 output convs, tanh and ``clip(mix - acc)`` stay plain
PyTorch, as they stay outside any Pallas kernel in the JAX package.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from waveunet_tpu_torch.config import Config
from waveunet_tpu_torch.device import DeviceLike, resolve_device
from waveunet_tpu_torch.ops import shapes
from waveunet_tpu_torch.ops.conv import (conv1d, conv1d_init, precision_scope,
                                         round_operands, same_pads)
from waveunet_tpu_torch.ops.kernels.conv1d_fused import conv1d_lrelu
from waveunet_tpu_torch.ops.kernels.interp import learned_interp
from waveunet_tpu_torch.ops.primitives import (audio_clip, crop,
                                              crop_and_concat, leaky_relu)
from waveunet_tpu_torch.ops.upsample import bilinear_x2, learned_interp_x2

Params = Dict[str, Dict[str, torch.Tensor]]


def _down_channels(cfg: Config, i: int) -> int:
    return cfg.num_initial_filters + cfg.num_initial_filters * i


def init_waveunet(generator: torch.Generator, cfg: Config,
                  device: DeviceLike = None) -> Params:
    """Glorot-uniform kernels, zero biases, uniform(+-sqrt(3/C)) interpolation
    weights, in the JAX package's shapes and key order. ``generator`` is a
    CPU ``torch.Generator``; the numbers differ from ``jax.random``'s."""
    dev = resolve_device(device)
    params: Params = {}
    in_ch = cfg.num_channels
    for i in range(cfg.num_layers):
        out_ch = _down_channels(cfg, i)
        params[f"down_{i}"] = conv1d_init(generator, cfg.filter_size, in_ch,
                                          out_ch, dev)
        in_ch = out_ch
    bott_ch = _down_channels(cfg, cfg.num_layers)
    params["bottleneck"] = conv1d_init(generator, cfg.filter_size, in_ch,
                                       bott_ch, dev)
    cur_ch = bott_ch
    for i in range(cfg.num_layers):
        if cfg.upsampling == "learned":
            lim = (3.0 / cur_ch) ** 0.5
            w = torch.empty((cur_ch,)).uniform_(-lim, lim, generator=generator)
            params[f"interp_{i}"] = {"weights": w.to(dev)}
        skip_ch = _down_channels(cfg, cfg.num_layers - i - 1)
        params[f"up_{i}"] = conv1d_init(generator, cfg.merge_filter_size,
                                        skip_ch + cur_ch, skip_ch, dev)
        cur_ch = skip_ch
    n_out = (cfg.num_sources if cfg.output_type == "direct"
             else cfg.num_sources - 1)
    for name in cfg.source_names[:n_out]:
        params[f"out_{name}"] = conv1d_init(
            generator, cfg.output_filter_size, cur_ch + cfg.num_channels,
            cfg.num_channels, dev)
    return params


def _conv_act(x: torch.Tensor, p: Dict[str, torch.Tensor],
              context: bool, bf16: bool) -> torch.Tensor:
    """conv + bias + LeakyReLU through the kernel wrapper; a same-padded
    conv pads explicitly (TF SAME: the odd extra sample at the end). With
    ``bf16`` the operands are rounded to bfloat16 first and the kernel
    accumulates them in fp32 (``ops/conv.py::round_operands``; the
    kernel's 3xTF32 arithmetic reads no TF32 switch, so its scope goes)."""
    w = p["kernel"]
    if not context:
        x = F.pad(x, (0, 0, *same_pads(x.shape[1], w.shape[0])))
    x, w, _ = round_operands(x, w, torch.bfloat16 if bf16 else None)
    return conv1d_lrelu(x, w, p["bias"])


def apply_waveunet(params: Params, cfg: Config, mix: torch.Tensor,
                   training: bool = False) -> Dict[str, torch.Tensor]:
    """Forward pass: mixture ``[B, in_len, C]`` -> {source: ``[B, out_len, C]``}.

    ``training=False`` runs under ``torch.no_grad()`` through the kernel
    wrappers (the hand-written kernels on the card). ``training=True`` is
    the differentiable forward of plain PyTorch ops (cuDNN convs on the
    card), with the JAX package's decimation lowering, ``remat`` and bf16
    training convs; no kernel wrapper is reached, since the kernels have no
    backward."""
    if cfg.network != "unet":
        raise NotImplementedError(f"network {cfg.network!r} is not ported")
    if training:
        with precision_scope(cfg.conv_precision):
            return _train_forward(params, cfg, mix)
    with torch.no_grad(), precision_scope(cfg.conv_precision):
        return _forward(params, cfg, mix)


def _output(params: Params, cfg: Config, mix: torch.Tensor, cur: torch.Tensor,
            conv, training: bool) -> Dict[str, torch.Tensor]:
    """The output convs with tanh or clip (clip at inference only), direct
    or difference output (the last source is mix - the others)."""
    if cfg.output_activation == "tanh":
        out_act = torch.tanh
    else:
        def out_act(x):
            return audio_clip(x, training)
    out: Dict[str, torch.Tensor] = {}
    if cfg.output_type == "direct":
        for name in cfg.source_names:
            out[name] = out_act(conv(cur, params[f"out_{name}"]))
        return out
    acc = None
    for name in cfg.source_names[:-1]:
        y = out_act(conv(cur, params[f"out_{name}"]))
        out[name] = y
        acc = y if acc is None else acc + y
    out[cfg.source_names[-1]] = audio_clip(crop(mix, acc.shape[1]) - acc,
                                           training)
    return out


def _forward(params: Params, cfg: Config,
             mix: torch.Tensor) -> Dict[str, torch.Tensor]:
    ctx = cfg.context
    bf16 = cfg.compute_dtype == "bfloat16"
    skips: List[torch.Tensor] = []
    cur = mix
    for i in range(cfg.num_layers):
        cur = _conv_act(cur, params[f"down_{i}"], ctx, bf16)
        skips.append(cur)
        cur = cur[:, ::2, :]  # decimate: a strided view, no copy
    cur = _conv_act(cur, params["bottleneck"], ctx, bf16)

    for i in range(cfg.num_layers):
        if cfg.upsampling == "learned":
            cur = learned_interp(cur, params[f"interp_{i}"]["weights"], ctx)
        else:
            cur = bilinear_x2(cur, ctx)
        skip = skips[-i - 1]
        if not ctx and skip.shape[1] != cur.shape[1]:
            raise ValueError(f"same-padding skip mismatch at layer {i}: "
                             f"{skip.shape[1]} vs {cur.shape[1]}")
        cur = _conv_act(crop_and_concat(skip, cur), params[f"up_{i}"], ctx,
                        bf16)

    cur = crop_and_concat(mix, cur)
    padding = "VALID" if ctx else "SAME"
    cdtype = torch.bfloat16 if bf16 else None

    def conv(x, p):
        return conv1d(x, p, padding=padding, compute_dtype=cdtype)
    return _output(params, cfg, mix, cur, conv, training=False)


def _train_forward(params: Params, cfg: Config,
                   mix: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The JAX package's ``apply_waveunet(training=True)`` in plain,
    differentiable PyTorch. Decimation is either the strided slice or, with
    ``decimate_lowering="dilate"``, folded into the next conv as stride 2
    and dilation 2 (bit-exact either way: out[i] = sum_t x[2i+2t] k[t]).
    bf16 training convs run wholly in bf16; ``remat`` recomputes each conv
    block in the backward (``torch.utils.checkpoint``)."""
    ctx = cfg.context
    padding = "VALID" if ctx else "SAME"
    cdtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
    use_dilate = cfg.decimate_lowering == "dilate" and cfg.num_layers > 0

    def conv(x, p, stride=1, dil=1):
        pad = padding
        if dil > 1 and padding == "SAME":
            # the half-rate conv's SAME pads, doubled into full-rate
            # coordinates (for an even width the asymmetry matters)
            w = p["kernel"].shape[0]
            lo = (w - 1) // 2
            pad = [(2 * lo, 2 * (w - 1 - lo))]
        return conv1d(x, p, padding=pad, stride=stride, rhs_dilation=dil,
                      compute_dtype=cdtype, fp32_accum=False)

    def conv_act(x, p):
        return leaky_relu(conv(x, p))

    def conv_act_dec(x, p):
        return leaky_relu(conv(x, p, stride=2, dil=2))

    if cfg.remat:
        conv_act, conv_act_dec = _remat(conv_act), _remat(conv_act_dec)

    skips: List[torch.Tensor] = []
    cur = mix
    for i in range(cfg.num_layers):
        f = conv_act_dec if (use_dilate and i > 0) else conv_act
        cur = f(cur, params[f"down_{i}"])
        skips.append(cur)
        if not use_dilate:
            cur = cur[:, ::2, :]
    cur = (conv_act_dec if use_dilate else conv_act)(cur, params["bottleneck"])

    for i in range(cfg.num_layers):
        if cfg.upsampling == "learned":
            cur = learned_interp_x2(cur, params[f"interp_{i}"]["weights"],
                                    ctx)
        else:
            cur = bilinear_x2(cur, ctx)
        skip = skips[-i - 1]
        if not ctx and skip.shape[1] != cur.shape[1]:
            raise ValueError(f"same-padding skip mismatch at layer {i}: "
                             f"{skip.shape[1]} vs {cur.shape[1]}")
        cur = conv_act(crop_and_concat(skip, cur), params[f"up_{i}"])

    cur = crop_and_concat(mix, cur)
    return _output(params, cfg, mix, cur, conv, training=True)


def _remat(fn):
    """``fn(x, p)`` recomputed in the backward instead of keeping its
    activations."""
    def wrapped(x, p):
        return checkpoint(lambda x, k, b: fn(x, {"kernel": k, "bias": b}),
                          x, p["kernel"], p["bias"], use_reentrant=False)
    return wrapped


def io_shapes(cfg: Config):
    """(input_len, output_len) for the configured desired ``num_frames``."""
    return shapes.get_padding(cfg, cfg.num_frames)
