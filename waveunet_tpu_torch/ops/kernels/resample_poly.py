"""Polyphase resampling with float64 sums: CUDA kernel, plain version,
wrapper.

The port's own kernel, with no Pallas counterpart: the JAX package
resamples on the host (scipy's ``upfirdn``) or with XLA convolutions. The
kernel is ``csrc/resample_poly.cu``; ``ops/resample.py::resample_device``
launches it for a CUDA tensor and takes the plain version
(``ops/resample.py::resample_polyphase``) for any other.

Shapes: x ``[n, C]`` fp32 or float64 -> ``[ceil(n * new / orig), C]``
fp32, the plan of ``ops/resample.py::_resample_plan``; the taps, float64,
are uploaded once per rate pair and card (``polyphase_bank``).
"""

from __future__ import annotations

from functools import lru_cache

import torch

from waveunet_tpu_torch.ops.kernels import build, refuse_autograd
from waveunet_tpu_torch.ops.resample import (_check_rates, _resample_plan,
                                             polyphase_bank)

# Kernel launches since the last reset; chip_smoke.py reads it to show that
# a path went through the kernel.
launches = 0


@lru_cache(maxsize=32)
def device_bank(p: int, q: int, device: torch.device) -> torch.Tensor:
    """``polyphase_bank(p, q)`` as a float64 tensor on ``device``, kept."""
    return torch.tensor(polyphase_bank(p, q)[0], device=device)


def resample_poly_cuda(x: torch.Tensor, orig_sr: int,
                       new_sr: int) -> torch.Tensor:
    """Launch the CUDA kernel on x's device and its current stream (no
    synchronise): ``[n, C]`` contiguous float32 or float64 to ``[n_out,
    C]`` float32. Refuses an input that requires grad under grad mode, and
    any tensor that is not a float32 or float64 CUDA one."""
    global launches
    refuse_autograd("resample_poly", x)
    if x.device.type != "cuda" or x.dtype not in (torch.float32,
                                                  torch.float64):
        raise ValueError(f"resample_poly: x must be a float32 or float64 "
                         f"CUDA tensor, got {x.dtype} on {x.device}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"resample_poly: x must be a contiguous [frames, "
                         f"channels] tensor, got {tuple(x.shape)}")
    _check_rates(orig_sr, new_sr)
    n, C = x.shape
    p, q, _, _, c, start, n_out = _resample_plan(n, orig_sr, new_sr)
    y = torch.empty((n_out, C), device=x.device, dtype=torch.float32)
    if n_out == 0:
        return y
    bank = device_bank(p, q, x.device)
    lib = build.load()
    with torch.cuda.device(x.device):  # the launcher runs on the current card
        launch = (lib.resample_poly_f64 if x.dtype == torch.float64
                  else lib.resample_poly_f32)
        status = launch(
            x.data_ptr(), bank.data_ptr(), y.data_ptr(), n, C, n_out, p, q,
            polyphase_bank(p, q)[1], bank.shape[1], c, start,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, f"resample_poly (x {n}x{C}, {orig_sr} -> {new_sr})")
    launches += 1
    return y
