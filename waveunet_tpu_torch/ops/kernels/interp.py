"""Learned x2 interpolation: CUDA kernel, plain version, wrapper.

Counterpart of ``waveunet_tpu/ops/pallas/interp.py::learned_interp_pallas``.
The kernel is ``csrc/learned_interp.cu`` and writes the whole output, the
tail row of both ``context`` modes included. ``learned_interp`` launches it
for a CUDA tensor and takes the plain version
(``ops/upsample.py::learned_interp_x2``) only for a CPU tensor.

Shapes: x ``[B, n, C]`` contiguous fp32, weights ``[C]`` (pre-sigmoid) ->
``[B, 2n-1, C]`` with context, ``[B, 2n, C]`` without.
"""

from __future__ import annotations

import torch

from waveunet_tpu_torch.ops.kernels import build, refuse_autograd
from waveunet_tpu_torch.ops.upsample import learned_interp_x2

# Kernel launches since the last reset; chip_smoke.py reads it to show that
# the main path went through the kernel.
launches = 0

learned_interp_plain = learned_interp_x2


def learned_interp_cuda(x: torch.Tensor, weights: torch.Tensor,
                        context: bool) -> torch.Tensor:
    """Launch the CUDA kernel on x's device and its current stream (no
    synchronise). The launcher refuses more than 2^31 input values."""
    global launches
    B, n, C = x.shape
    for name, t in (("x", x), ("weights", weights)):
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise ValueError(f"learned_interp: {name} must be a float32 CUDA "
                             f"tensor, got {t.dtype} on {t.device}")
    if weights.shape != (C,) or weights.device != x.device:
        raise ValueError(f"learned_interp: weights {tuple(weights.shape)} on "
                         f"{weights.device} do not fit x {tuple(x.shape)}")
    if not (x.is_contiguous() and weights.is_contiguous()):
        raise ValueError("learned_interp: x and weights must be contiguous")
    y = torch.empty((B, 2 * n - 1 if context else 2 * n, C), device=x.device,
                    dtype=torch.float32)
    lib = build.load()
    with torch.cuda.device(x.device):  # the launcher runs on the current card
        status = lib.learned_interp_f32(
            x.data_ptr(), weights.data_ptr(), y.data_ptr(), B, n, C,
            int(context), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, f"learned_interp (x {B}x{n}x{C})")
    launches += 1
    return y


def learned_interp(x: torch.Tensor, weights: torch.Tensor,
                   context: bool) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor.
    Either way it refuses an input that requires grad under grad mode."""
    refuse_autograd("learned_interp", x, weights)
    if x.device.type == "cuda":
        return learned_interp_cuda(x, weights, context)
    if x.device.type != "cpu":
        raise ValueError(f"learned_interp: unsupported device {x.device}")
    return learned_interp_plain(x, weights, context)
