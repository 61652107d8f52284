"""The int16 wire between host and device, both directions.

Host to device: ``quantize_int16`` turns a float song into int16 exactly as
the JAX package's native host op does (``waveunet_tpu/runtime/host_ops.cc``
``quantize_int16``): clip to [-1, 1], scale by 32767 and round half away
from zero, every step in float32 (the ``+ 0.5`` is itself rounded to
float32 before the truncation toward zero). ``np.round`` rounds half to
even and differs on a few hundred samples of a million; the network would
see another input.

Device to host: ``to_wire`` quantises a model output on the device with
``torch.round`` (half to even, as ``jnp.round`` in the JAX engine), and
``INT16_NONFINITE`` carries NaN/Inf: quantised audio is clipped to
[-32767, 32767], so INT16_MIN is free, and ``from_wire`` turns it back into
NaN instead of laundering a diverged model into finite audio.

``dequantize`` divides by a 0-d float32 tensor of 32767 on the operand's
device, as the JAX package divides by 32767.0: on a CUDA tensor, PyTorch's
true division by a host scalar multiplies by the scalar's reciprocal, which
can land one ulp away from the quotient.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

INT16_NONFINITE = -32768
SCALE = 32767.0

_FULL_SCALE: Dict[torch.device, torch.Tensor] = {}


def quantize_int16(x: np.ndarray) -> np.ndarray:
    """float audio -> int16, bit for bit the JAX package's host quantiser."""
    v = np.clip(np.asarray(x, np.float32), np.float32(-1.0), np.float32(1.0))
    s = v * np.float32(SCALE)
    half = np.float32(0.5)
    return np.where(s >= 0, s + half, s - half).astype(np.int16)


def to_wire(v: torch.Tensor) -> torch.Tensor:
    """Device quantiser of a model output: int16, NaN/Inf as the sentinel."""
    q = torch.round(torch.clamp(v, -1.0, 1.0) * SCALE)
    return torch.where(torch.isfinite(v), q,
                       torch.full_like(v, INT16_NONFINITE)).to(torch.int16)


def full_scale(device: torch.device) -> torch.Tensor:
    """The divisor of ``dequantize`` on ``device``, made once per device.
    It must exist before a CUDA graph that divides by it is captured: a
    tensor made during a capture lives in the graph's private pool."""
    t = _FULL_SCALE.get(device)
    if t is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"full_scale({device}) was first asked for "
                               f"inside a CUDA graph capture; call it before")
        t = torch.full((), SCALE, dtype=torch.float32, device=device)
        _FULL_SCALE[device] = t
    return t


def dequantize(w: torch.Tensor) -> torch.Tensor:
    """int16 -> float32 by a true division by 32767, on any device."""
    return w.to(torch.float32) / full_scale(w.device)


def from_wire(w: torch.Tensor) -> torch.Tensor:
    """int16 (device or host tensor) -> float32, the sentinel as NaN."""
    f = dequantize(w)
    return torch.where(w == INT16_NONFINITE,
                       torch.full_like(f, float("nan")), f)


def from_wire_np(w: np.ndarray) -> np.ndarray:
    """Host counterpart of ``from_wire`` over a numpy int16 array."""
    f = w.astype(np.float32) / np.float32(SCALE)
    f[w == INT16_NONFINITE] = np.nan
    return f
