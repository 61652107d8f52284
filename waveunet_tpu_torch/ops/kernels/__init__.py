"""The port's hand-written CUDA kernels and their launch counters.

Each kernel module keeps a ``launches`` counter that its wrapper bumps once
per kernel launch. A CUDA graph launches its kernels without calling the
wrappers, so whoever replays a graph adds the graph's own counts
(``add_launches``), and a capture, which launches nothing, takes back what
the wrappers counted while it recorded (``add_launches(counts, -1)``).
"""

from __future__ import annotations

import importlib
from typing import Dict, Mapping

# kernel name -> the module holding its wrapper and counter
KERNEL_MODULES = {
    "conv1d_lrelu": "waveunet_tpu_torch.ops.kernels.conv1d_fused",
    "learned_interp": "waveunet_tpu_torch.ops.kernels.interp",
    "conv1d_lrelu_im2col": "waveunet_tpu_torch.ops.kernels.conv1d_im2col",
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
