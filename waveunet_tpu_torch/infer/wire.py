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
"""

from __future__ import annotations

import numpy as np
import torch

INT16_NONFINITE = -32768
SCALE = 32767.0


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


def from_wire(w: torch.Tensor) -> torch.Tensor:
    """int16 (device or host tensor) -> float32, the sentinel as NaN."""
    f = w.to(torch.float32) / SCALE
    return torch.where(w == INT16_NONFINITE,
                       torch.full_like(f, float("nan")), f)


def from_wire_np(w: np.ndarray) -> np.ndarray:
    """Host counterpart of ``from_wire`` over a numpy int16 array."""
    f = w.astype(np.float32) / np.float32(SCALE)
    f[w == INT16_NONFINITE] = np.nan
    return f
