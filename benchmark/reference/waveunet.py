"""The Wave-U-Net forward in plain PyTorch, channels first.

Stoller et al. 2018 (arXiv:1806.03185), section 3: ``num_layers`` down
blocks (conv of ``filter_size`` + LeakyReLU(0.2), kept as a skip, then
every second sample), a bottleneck conv, ``num_layers`` up blocks (x2
upsampling, the skip centre-cropped and concatenated before the new
features, conv of ``merge_filter_size`` + LeakyReLU), the (cropped) input
concatenated last, and a K=1 output conv with tanh per source; the
benchmark's configurations are the context (valid-convolution) presets.
With the difference output the last source is the cropped mix minus the
others, clipped to [-1, 1] at inference. Upsampling keeps the samples at even
positions and puts between neighbours a and b the value s*a + (1-s)*b:
s = 1/2 for bilinear, s = sigmoid(w) per channel for the learned one; the
result has 2n - 1 samples.

Parameters are ``{layer: {"kernel": [K, Cin, Cout], "bias": [Cout]}}`` and
``{"interp_i": {"weights": [C]}}``, the layout the benchmark's weights are
made in. Every convolution runs with TF32 off; ``precision="tf32"`` rounds
its two operands to TF32 first and allows TF32 on the card, so a
backward's convolutions take it too (the control).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Mapping

import torch
import torch.nn.functional as F

from benchmark.reference.sources import source_names

ALPHA = 0.2


@contextlib.contextmanager
def tf32(allow: bool):
    """cuDNN and cuBLAS with TF32 allowed or not while the block runs."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = allow
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest TF32 value (10 mantissa bits, ties to
    even), as float32; the gradient passes through unchanged."""
    bits = x.detach().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    r = ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)
    return x + (r - x).detach() if x.requires_grad else r


def conv(x: torch.Tensor, p: Mapping, precision: str) -> torch.Tensor:
    """Valid conv of channels-first ``x`` [B, Cin, L] with a [K, Cin, Cout]
    kernel, plus bias."""
    w = p["kernel"].permute(2, 1, 0)  # [Cout, Cin, K]
    if precision == "tf32":
        x, w = round_tf32(x), round_tf32(w)
    elif precision != "fp32":
        raise ValueError(f"precision {precision!r}")
    return F.conv1d(x, w.contiguous(), p["bias"])


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, ALPHA * x)


def upsample(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x2 upsampling of [B, C, n] to [B, C, 2n - 1] (the context presets)
    with the per-channel share ``s`` [C] of the left neighbour."""
    B, C, n = x.shape
    s = s.view(1, C, 1)
    out = x.new_empty((B, C, 2 * n - 1))
    out[:, :, 0::2] = x
    out[:, :, 1::2] = s * x[:, :, :-1] + (1 - s) * x[:, :, 1:]
    return out


def centre_crop(x: torch.Tensor, n: int) -> torch.Tensor:
    d = x.shape[2] - n
    if d < 0:
        raise ValueError(f"cannot crop {x.shape[2]} samples to {n}")
    return x[:, :, d // 2:d // 2 + n]


def forward(params: Mapping, arch: Mapping, mix: torch.Tensor,
            training: bool = False,
            precision: str = "fp32") -> Dict[str, torch.Tensor]:
    """Windows ``mix`` [B, in_len, C] -> {source: [B, out_len, C]}."""
    if not arch["context"] or arch["output_activation"] != "tanh":
        raise NotImplementedError("the reference covers the context "
                                  "(valid-convolution) presets with tanh")
    with tf32(precision == "tf32"), torch.set_grad_enabled(training):
        return _forward(params, arch, mix.transpose(1, 2), training,
                        precision)


def _forward(params, arch, x0, training, precision):
    L = arch["num_layers"]
    skips: List[torch.Tensor] = []
    x = x0
    for i in range(L):
        x = lrelu(conv(x, params[f"down_{i}"], precision))
        skips.append(x)
        x = x[:, :, ::2]
    x = lrelu(conv(x, params["bottleneck"], precision))
    for i in range(L):
        if arch["upsampling"] == "learned":
            s = torch.sigmoid(params[f"interp_{i}"]["weights"])
        else:
            s = torch.full((x.shape[1],), 0.5, dtype=x.dtype,
                           device=x.device)
        x = upsample(x, s)
        x = torch.cat([centre_crop(skips[-i - 1], x.shape[2]), x], dim=1)
        x = lrelu(conv(x, params[f"up_{i}"], precision))
    x = torch.cat([centre_crop(x0, x.shape[2]), x], dim=1)
    names = source_names(arch)
    out: Dict[str, torch.Tensor] = {}
    if arch["output_type"] == "direct":
        for n in names:
            out[n] = torch.tanh(conv(x, params[f"out_{n}"], precision))
    else:
        acc = 0
        for n in names[:-1]:
            out[n] = torch.tanh(conv(x, params[f"out_{n}"], precision))
            acc = acc + out[n]
        last = centre_crop(x0, x.shape[2]) - acc
        out[names[-1]] = last if training else torch.clamp(last, -1.0, 1.0)
    return {n: v.transpose(1, 2) for n, v in out.items()}
