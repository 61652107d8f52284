"""Wave-U-Net (``"network": "unet"``): Stoller et al. 2018, arXiv:1806.03185.

Weights: one uniform draw cut into the Wave-U-Net's leaves (``down_i``,
``bottleneck``, ``interp_i``, ``up_i``, ``out_<source>``; TF layouts) and
scaled per leaf: Glorot-uniform kernels, biases uniform in +-0.05
(nonzero, so that a lost bias shows), interpolation weights uniform in
+-sqrt(3 / C). The model has no state.

Its reference is ``reference/waveunet.py`` (the forward),
``reference/shapes.py`` (the valid-convolution windows) and
``reference/train.py`` (the training steps); its work is every conv and
learned interpolation of the forward (``calls``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping

import torch

from benchmark import inputs
from benchmark.reference import shapes, train, waveunet
from benchmark.reference.sources import source_names
from benchmark.work import Call, F32, conv_call

# The CPU rehearsal's cut: every width and length, nothing else.
TINY = {"num_layers": 3, "num_initial_filters": 4, "num_frames": 1024,
        "infer_batch": 4, "train_songs": 2, "train_song_s": 0.5}

# The ops whose FLOPs the mfu readers count: the convs; the interpolations'
# few FLOPs are the roofline's alone.
FLOP_OPS = ("conv", "conv_out")


def leaf_shapes(arch: Mapping) -> Dict[str, Dict[str, tuple]]:
    """{layer: {leaf: shape}} of the Wave-U-Net's parameters."""
    L, f0 = arch["num_layers"], arch["num_initial_filters"]
    C = 1 if arch["mono_downmix"] else 2
    out: Dict[str, Dict[str, tuple]] = {}

    def conv(name, k, cin, cout):
        out[name] = {"kernel": (k, cin, cout), "bias": (cout,)}

    cin = C
    for i in range(L):
        conv(f"down_{i}", arch["filter_size"], cin, f0 * (i + 1))
        cin = f0 * (i + 1)
    conv("bottleneck", arch["filter_size"], cin, f0 * (L + 1))
    cur = f0 * (L + 1)
    for i in range(L):
        if arch["upsampling"] == "learned":
            out[f"interp_{i}"] = {"weights": (cur,)}
        skip = f0 * (L - i)
        conv(f"up_{i}", arch["merge_filter_size"], skip + cur, skip)
        cur = skip
    names = source_names(arch)
    n_out = len(names) - (1 if arch["output_type"] == "difference" else 0)
    for name in names[:n_out]:
        conv(f"out_{name}", arch["output_filter_size"], cur + C, C)
    return out


def _limit(leaf: str, shape: tuple) -> float:
    if leaf == "kernel":
        k, cin, cout = shape
        return math.sqrt(6.0 / (k * cin + k * cout))
    if leaf == "bias":
        return 0.05
    return math.sqrt(3.0 / shape[0])


def weights(arch: Mapping, seed: int, device: torch.device):
    """(params, state): the seeded weights, made on ``device`` in one
    draw, and the model's (empty) state."""
    return inputs.uniform_leaves(leaf_shapes(arch), _limit, seed,
                                 device), {}


def window(arch: Mapping):
    """(input, output) of the inference window."""
    return shapes.get_padding(arch, shapes.infer_frames(arch))


def forward(params: Mapping, state: Mapping, arch: Mapping,
            wins: torch.Tensor, precision: str):
    return waveunet.forward(params, arch, wins, precision=precision)


def interp_call(b: int, n: int, c: int) -> Call:
    """A learned x2 interpolation of ``b`` rows of ``n`` samples and ``c``
    channels to 2n - 1 samples: three FLOPs an interpolated value."""
    return Call("interp", 3.0 * b * (n - 1) * c,
                F32 * (b * n * c + c + b * (2 * n - 1) * c))


def calls(arch: Mapping, in_len: int, b: int = 1) -> List[Call]:
    """Every conv and interpolation of a forward over ``b`` windows of
    ``in_len`` samples, in the order the model runs them."""
    out = []
    L, f0 = arch["num_layers"], arch["num_initial_filters"]
    C = 1 if arch["mono_downmix"] else 2
    n, cin, skips = in_len, C, []
    for i in range(L):
        cout = f0 * (i + 1)
        out.append(conv_call(b, n, arch["filter_size"], cin, cout))
        n = n - arch["filter_size"] + 1
        skips.append(cout)
        n, cin = (n + 1) // 2, cout
    out.append(conv_call(b, n, arch["filter_size"], cin, f0 * (L + 1)))
    n, cin = n - arch["filter_size"] + 1, f0 * (L + 1)
    for i in range(L):
        if arch["upsampling"] == "learned":
            out.append(interp_call(b, n, cin))
        n = 2 * n - 1
        cin = cin + skips[-i - 1]
        cout = skips[-i - 1]
        out.append(conv_call(b, n, arch["merge_filter_size"], cin, cout))
        n, cin = n - arch["merge_filter_size"] + 1, cout
    n_out = len(source_names(arch)) - (
        1 if arch["output_type"] == "difference" else 0)
    for _ in range(n_out):
        out.append(conv_call(b, n, arch["output_filter_size"], cin + C, C,
                             op="conv_out"))
    return out


# -- training hooks -----------------------------------------------------------

reference_steps = train.run_steps


def train_window(arch: Mapping):
    """(input, output) of the training window."""
    return shapes.get_padding(arch, arch["num_frames"])


def train_flops(arch: Mapping, in_len: int) -> int:
    """A training step's FLOPs a window: three forwards' worth of convs
    (the forward, and the backward's two products a conv)."""
    return 3 * waveunet_conv_flops(arch, in_len)


def waveunet_conv_flops(cfg, in_len: int) -> int:
    """Multiply-add FLOPs (2 per MAC) of every conv of one window of the
    Wave-U-Net forward, walked from the input length as the model runs.
    (A copy of ``waveunet_tpu_torch/bench.py::waveunet_conv_flops``, over
    a configuration's keys.)"""
    ctx, f0 = cfg["context"], cfg["num_initial_filters"]
    num_channels = 1 if cfg["mono_downmix"] else 2
    L, cin, flops = in_len, num_channels, 0

    def conv(L, K, cin, cout):
        L_out = L - K + 1 if ctx else L
        return L_out, 2 * L_out * K * cin * cout

    skips = []
    for i in range(cfg["num_layers"]):
        cout = f0 + f0 * i
        L, fl = conv(L, cfg["filter_size"], cin, cout)
        flops += fl
        skips.append((L, cout))
        L, cin = (L + 1) // 2, cout
    cout = f0 + f0 * cfg["num_layers"]
    L, fl = conv(L, cfg["filter_size"], cin, cout)
    flops += fl
    cin = cout
    for i in range(cfg["num_layers"]):
        L = 2 * L - 1 if ctx else 2 * L
        skip_ch = skips[-i - 1][1]
        L, fl = conv(L, cfg["merge_filter_size"], skip_ch + cin, skip_ch)
        flops += fl
        cin = skip_ch
    n_sources = len(source_names(cfg))
    n_out = n_sources if cfg["output_type"] == "direct" else n_sources - 1
    _, fl = conv(L, cfg["output_filter_size"], cin + num_channels,
                 num_channels)
    return flops + n_out * fl
