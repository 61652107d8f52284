"""The work of a forward, from shapes alone: the arithmetic of the calls.

Each model family lists the calls of its forward (``families/<network>.py
::calls``); this module holds what they are made of and how a request
chunks them.

Counts what the function needs, whatever implements it: a conv's FLOPs
once (two a multiply-add), not three times for a 3xTF32 scheme; each input
byte read once a call and each output byte written once; and only the
windows that the requests need, not the padded slots of a chunk. The
peaks are an H100 SXM's (NVIDIA's data sheet, dense): 495 TFLOP/s in
TF32, the fastest tensor-core rate that can carry an fp32-accurate
product, and 3.35 TB/s of HBM3.
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Mapping, NamedTuple

PEAK_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
F32 = 4


class Call(NamedTuple):
    op: str        # the family's name for the call, by which a roofline
                   # reader picks it
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


def chunks(n_windows: int, batch: int) -> Iterator[int]:
    """The needed windows of one request, ``batch`` at a time."""
    while n_windows > 0:
        yield min(batch, n_windows)
        n_windows -= batch


def request_calls(calls: Callable[[Mapping, int, int], List[Call]],
                  arch: Mapping, in_len: int, n_windows: int
                  ) -> Iterator[Call]:
    """The calls a request of ``n_windows`` windows needs, in chunks of the
    configuration's ``infer_batch``; ``calls(arch, in_len, b)`` is the
    family's one forward over ``b`` windows."""
    for b in chunks(n_windows, arch["infer_batch"]):
        yield from calls(arch, in_len, b)
