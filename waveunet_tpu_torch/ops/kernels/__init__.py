"""The port's hand-written CUDA kernels and their launch counters.

Each kernel module keeps a ``launches`` counter that its wrapper bumps once
per kernel launch. A CUDA graph launches its kernels without calling the
wrappers, so whoever replays a graph adds the graph's own counts
(``add_launches``), and a capture, which launches nothing, takes back what
the wrappers counted while it recorded (``add_launches(counts, -1)``).
``capture`` and ``Graph`` do both, for every graph the port captures.

The kernels have no backward. A wrapper therefore refuses an input that
requires grad while grad mode is on (``refuse_autograd``), on the CPU as on
the card: on a CUDA tensor its output would carry no ``grad_fn``, and the
parameters behind it would never learn. Training runs the plain,
differentiable ops (``models/waveunet.py``), and inference runs under
``torch.no_grad()``.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict, Mapping, Tuple

import torch

# kernel name -> the module holding its wrapper and counter
KERNEL_MODULES = {
    "conv1d_lrelu": "waveunet_tpu_torch.ops.kernels.conv1d_fused",
    "learned_interp": "waveunet_tpu_torch.ops.kernels.interp",
    "conv1d_lrelu_im2col": "waveunet_tpu_torch.ops.kernels.conv1d_im2col",
    "resample_poly": "waveunet_tpu_torch.ops.kernels.resample_poly",
}


def launch_counts() -> Dict[str, int]:
    """Every kernel's launch counter, by kernel name."""
    return {name: importlib.import_module(mod).launches
            for name, mod in KERNEL_MODULES.items()}


def add_launches(counts: Mapping[str, int], sign: int = 1) -> None:
    """Add ``sign * counts[name]`` to each named kernel's counter."""
    for name, n in counts.items():
        importlib.import_module(KERNEL_MODULES[name]).launches += sign * n


def reset_launches() -> None:
    for mod in KERNEL_MODULES.values():
        importlib.import_module(mod).launches = 0


def refuse_autograd(op: str, *tensors: torch.Tensor) -> None:
    """Raise if grad mode is on and any input requires grad: the kernel
    ``op`` has no backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{op}: the hand-written kernel has no backward, and an input "
            f"requires grad; run inference under torch.no_grad(), and "
            f"training through the plain differentiable ops")


class Graph:
    """One captured CUDA graph: its static inputs and outputs, the kernel
    launches one replay makes, and how often it was replayed."""

    def __init__(self, graph, inputs, outputs, launches: Dict[str, int]):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs
        self.launches = launches
        self.replays = 0

    def replay(self):
        self.graph.replay()
        self.replays += 1
        add_launches(self.launches)
        return self.outputs


def capture(fn: Callable, inputs: Tuple[torch.Tensor, ...] = (),
            pool=None) -> Graph:
    """Run ``fn(*inputs)`` once eagerly on a side stream (kernel library,
    launch plans, cuDNN, cuBLAS and cuFFT handles and plans, the allocator),
    then capture it as a CUDA graph over the same static ``inputs``; the
    eager run is real work, the capture runs nothing. The capture is
    thread-local, so host copies made by another thread meanwhile (a
    background checkpoint write) do not invalidate it. A failed capture
    raises."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*inputs)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    before = launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
        outputs = fn(*inputs)
    # the wrappers counted while the graph recorded; nothing launched
    recorded = {k: v - before[k] for k, v in launch_counts().items()}
    add_launches(recorded, -1)
    return Graph(graph, inputs, outputs, recorded)
