"""The work of the forward and of the training step, from shapes alone.

Counts what the function needs, whatever implements it: a conv's FLOPs
once (two a multiply-add), not three times for a 3xTF32 scheme; each input
byte read once a call and each output byte written once; and only the
windows that the requests need, not the padded slots of a chunk. The
peaks are an H100 SXM's (NVIDIA's data sheet, dense): 495 TFLOP/s in
TF32, the fastest tensor-core rate that can carry an fp32-accurate
product, and 3.35 TB/s of HBM3.
"""

from __future__ import annotations

from typing import Iterator, List, Mapping, NamedTuple

from benchmark.reference import shapes

PEAK_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
F32 = 4


class Call(NamedTuple):
    op: str        # "conv" (a conv + bias + LeakyReLU), "conv_out" (the
                   # K=1 output conv, no activation) or "interp"
    flops: float
    bytes: float

    def bound_s(self) -> float:
        return max(self.flops / PEAK_FLOPS, self.bytes / PEAK_BYTES_PER_S)


def conv_call(b: int, l_in: int, k: int, cin: int, cout: int,
              op: str = "conv") -> Call:
    """A valid conv of ``b`` rows of ``l_in`` samples and ``cin`` channels
    to ``cout`` channels with ``k`` taps, plus bias."""
    l_out = l_in - k + 1
    return Call(op, 2.0 * b * l_out * k * cin * cout,
                F32 * (b * l_in * cin + k * cin * cout + cout
                       + b * l_out * cout))


def interp_call(b: int, n: int, c: int) -> Call:
    """A learned x2 interpolation of ``b`` rows of ``n`` samples and ``c``
    channels to 2n - 1 samples: three FLOPs an interpolated value."""
    return Call("interp", 3.0 * b * (n - 1) * c,
                F32 * (b * n * c + c + b * (2 * n - 1) * c))


def forward_calls(arch: Mapping, in_len: int, b: int = 1) -> List[Call]:
    """Every conv and interpolation of a forward over ``b`` windows of
    ``in_len`` samples, in the order the model runs them."""
    calls = []
    L, f0 = arch["num_layers"], arch["num_initial_filters"]
    C = 1 if arch["mono_downmix"] else 2
    n, cin, skips = in_len, C, []
    for i in range(L):
        cout = f0 * (i + 1)
        calls.append(conv_call(b, n, arch["filter_size"], cin, cout))
        n = n - arch["filter_size"] + 1
        skips.append(cout)
        n, cin = (n + 1) // 2, cout
    calls.append(conv_call(b, n, arch["filter_size"], cin, f0 * (L + 1)))
    n, cin = n - arch["filter_size"] + 1, f0 * (L + 1)
    for i in range(L):
        if arch["upsampling"] == "learned":
            calls.append(interp_call(b, n, cin))
        n = 2 * n - 1
        cin = cin + skips[-i - 1]
        cout = skips[-i - 1]
        calls.append(conv_call(b, n, arch["merge_filter_size"], cin, cout))
        n, cin = n - arch["merge_filter_size"] + 1, cout
    n_out = len(shapes.source_names(arch)) - (
        1 if arch["output_type"] == "difference" else 0)
    for _ in range(n_out):
        calls.append(conv_call(b, n, arch["output_filter_size"], cin + C, C,
                               op="conv_out"))
    return calls


def chunks(n_windows: int, batch: int) -> Iterator[int]:
    """The needed windows of one request, ``batch`` at a time."""
    while n_windows > 0:
        yield min(batch, n_windows)
        n_windows -= batch


def request_calls(arch: Mapping, in_len: int, n_windows: int
                  ) -> Iterator[Call]:
    """The calls a request of ``n_windows`` windows needs, in chunks of the
    configuration's ``infer_batch``."""
    for b in chunks(n_windows, arch["infer_batch"]):
        yield from forward_calls(arch, in_len, b)


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
    n_sources = len(shapes.source_names(cfg))
    n_out = n_sources if cfg["output_type"] == "direct" else n_sources - 1
    _, fl = conv(L, cfg["output_filter_size"], cin + num_channels,
                 num_channels)
    return flops + n_out * fl
