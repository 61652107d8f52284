"""Convolutions in the TF layouts, parameter initialisation, precision.

PyTorch counterpart of ``waveunet_tpu/ops/conv.py`` (``conv1d``,
``conv2d``, ``conv2d_transpose``, ``glorot_uniform`` and the inits). Layouts
match TF so converted checkpoints and the JAX package's parameters drop
straight in: a conv1d kernel is ``[width, in, out]`` over activations
``[B, L, C]``; a conv2d kernel ``[h, w, in, out]`` and a conv2d_transpose
kernel ``[h, w, out, in]`` over ``[B, H, W, C]``.

At inference the plain conv1d serves the convs that no kernel of the port
covers (the K=1 output convs); every conv followed by LeakyReLU goes
through ``ops/kernels/conv1d_fused.py`` instead. In training every conv is
this differentiable one (cuDNN on the card), as the JAX package keeps its
Pallas kernels out of training. The 2-D convs of the spectrogram
U-Net are cuDNN calls, as they are ``lax`` convolutions outside any Pallas
kernel in the JAX package; TF32 follows ``precision_scope``.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Iterator, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

Padding = Union[str, Sequence[Tuple[int, int]]]

# Config.conv_precision -> whether fp32 convs and matmuls that run through
# PyTorch may use TF32. None means the port's default, full fp32: cuDNN
# allows TF32 for fp32 convs unless told otherwise, which keeps only about
# three decimal digits and breaks the 2e-5 parity with the JAX package.
# "high" is full fp32 too: JAX's HIGH (three bf16 passes, about fp32's
# accuracy) is finer than TF32's 10 mantissa bits. Only "default" (JAX: one
# bf16 pass) allows TF32.
ALLOW_TF32 = {None: False, "highest": False, "high": False, "default": True}


# TF32 switches are process-wide, and the device scorer of the eval harness
# (eval/bsseval_tpu.py) runs in a thread beside the separating one: each
# holds this lock while its switches are set, so neither enqueues work under
# the other's setting.
_TF32_LOCK = threading.RLock()


@contextlib.contextmanager
def tf32_scope(allow_tf32: bool) -> Iterator[None]:
    """Set cuDNN's and cuBLAS's TF32 switches to ``allow_tf32`` while the
    block runs, holding them against other threads' scopes, and restore the
    caller's settings after it."""
    with _TF32_LOCK:
        prev = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32
        try:
            yield
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = prev


def precision_scope(conv_precision: Optional[str]):
    """``tf32_scope`` for ``conv_precision``."""
    return tf32_scope(ALLOW_TF32[conv_precision])


def glorot_uniform(shape: Sequence[int], generator: torch.Generator,
                   device=None, dtype=torch.float32) -> torch.Tensor:
    """TF-default glorot_uniform: fan_in/fan_out over the last two dims,
    scaled by the receptive field size."""
    receptive = math.prod(shape[:-2]) if len(shape) > 2 else 1
    fan_in = shape[-2] * receptive
    fan_out = shape[-1] * receptive
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    t = torch.empty(tuple(shape), dtype=dtype)
    t.uniform_(-limit, limit, generator=generator)
    return t.to(device)


def conv1d_init(generator: torch.Generator, width: int, in_ch: int,
                out_ch: int, device=None, dtype=torch.float32):
    return {
        "kernel": glorot_uniform((width, in_ch, out_ch), generator, device,
                                 dtype),
        "bias": torch.zeros((out_ch,), dtype=dtype, device=device),
    }


def conv2d_init(generator: torch.Generator, hw: Tuple[int, int], in_ch: int,
                out_ch: int, device=None, dtype=torch.float32,
                transpose: bool = False):
    """A conv2d kernel ``[h, w, in, out]``, or with ``transpose`` a
    conv2d_transpose kernel ``[h, w, out, in]``, and a zero bias."""
    shape = ((hw[0], hw[1], out_ch, in_ch) if transpose
             else (hw[0], hw[1], in_ch, out_ch))
    return {
        "kernel": glorot_uniform(shape, generator, device, dtype),
        "bias": torch.zeros((out_ch,), dtype=dtype, device=device),
    }


def same_pads(length: int, width: int, stride: int = 1,
              dilation: int = 1) -> Tuple[int, int]:
    """TF's SAME padding (lo, hi) for one spatial dim: the extra sample of an
    odd total goes at the end."""
    out = -(-length // stride)
    total = max((out - 1) * stride + (width - 1) * dilation + 1 - length, 0)
    return total // 2, total - total // 2


def conv1d(x: torch.Tensor, params, *, padding: Padding = "VALID",
           stride: int = 1, rhs_dilation: int = 1,
           compute_dtype: Optional[torch.dtype] = None,
           fp32_accum: bool = True) -> torch.Tensor:
    """1-D convolution over ``[B, W, C]`` with a TF-layout kernel
    ``[w, in, out]``; ``padding`` is "VALID", "SAME" or ``[(lo, hi)]``.

    ``compute_dtype`` (bfloat16) rounds x and the kernel to it. With
    ``fp32_accum`` (inference) the conv then runs in fp32 on the rounded
    values: a bf16 product is exact in fp32, so this is bf16 operands with
    fp32 accumulation, the JAX package's ``preferred_element_type``.
    Without it (training) the conv runs wholly in ``compute_dtype``, as the
    JAX package's differentiated bf16 convs do.

    The bias is added in fp32 (fp64 for a float64 input) and the result
    returns in the input's dtype. TF32 follows the ambient
    ``precision_scope``."""
    k, b = params["kernel"], params["bias"]
    in_dtype = x.dtype
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        k = k.to(compute_dtype)
        if fp32_accum:
            x, k = x.float(), k.float()
    if padding == "VALID":
        lo, hi = 0, 0
    elif padding == "SAME":
        lo, hi = same_pads(x.shape[1], k.shape[0], stride, rhs_dilation)
    else:
        (lo, hi), = padding
    xc = F.pad(x.transpose(1, 2), (lo, hi))          # [B, C, W + lo + hi]
    y = F.conv1d(xc, k.permute(2, 1, 0), stride=stride,
                 dilation=rhs_dilation)               # [B, out, W']
    acc = torch.promote_types(in_dtype, torch.float32)
    y = y.transpose(1, 2).to(acc) + b.to(acc)
    return y.to(in_dtype)


def conv2d(x: torch.Tensor, params, *, stride: Tuple[int, int] = (1, 1),
           padding: str = "SAME") -> torch.Tensor:
    """2-D convolution over ``[B, H, W, C]`` with a TF-layout kernel
    ``[h, w, in, out]``; TF's SAME puts an odd extra pad at the end."""
    k, b = params["kernel"], params["bias"]
    kh, kw = k.shape[0], k.shape[1]
    xc = x.permute(0, 3, 1, 2)                        # [B, C, H, W]
    if padding == "SAME":
        ph = same_pads(x.shape[1], kh, stride[0])
        pw = same_pads(x.shape[2], kw, stride[1])
        xc = F.pad(xc, (*pw, *ph))
    elif padding != "VALID":
        raise ValueError(f"padding {padding!r}: use 'SAME' or 'VALID'")
    y = F.conv2d(xc, k.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1) + b


def conv2d_transpose(x: torch.Tensor, params, *,
                     stride: Tuple[int, int] = (2, 2),
                     padding: str = "SAME") -> torch.Tensor:
    """2-D transposed convolution as ``tf.layers.conv2d_transpose``: the
    gradient of a conv2d whose kernel, read as ``[h, w, in, out]``, is this
    ``[h, w, out, in]`` kernel. The full transposed output is cropped by the
    forward conv's SAME pads, so a SAME output is ``stride`` times the
    input; ``conv_transpose2d`` flips the taps as the gradient does."""
    if padding != "SAME":
        raise ValueError(f"padding {padding!r}: only 'SAME' is ported")
    k, b = params["kernel"], params["bias"]
    kh, kw = k.shape[0], k.shape[1]
    H, W = x.shape[1] * stride[0], x.shape[2] * stride[1]
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1),
                           stride=stride)            # [B, out, H', W']
    ph = same_pads(H, kh, stride[0])[0]
    pw = same_pads(W, kw, stride[1])[0]
    y = y[:, :, ph:ph + H, pw:pw + W]
    return y.permute(0, 2, 3, 1) + b
