"""Channel-major fused valid conv1d + bias + LeakyReLU as one GEMM over K*Cin:
CUDA kernel, plain version, wrapper.

Counterpart of ``waveunet_tpu/ops/pallas/conv1d_im2col.py:44``
(``conv1d_lrelu_im2col``). The kernel is ``csrc/conv1d_lrelu_im2col.cu`` (its
header says what bounds it and how it is tiled). ``conv1d_lrelu_im2col``
launches it for a CUDA tensor and takes the plain PyTorch version only for a
CPU tensor.

Shapes: x ``[B, Cin, L]`` (any batch, channel and time stride, so a decimated
view ``x[:, :, ::2]`` goes in without a copy), w ``[K, Cin, Cout]`` (TF
layout, as the JAX function takes it), b ``[Cout]`` ->
``[B, Cout, L - K + 1]``, all fp32. The LeakyReLU slope is the model's 0.2,
a constant here and in the kernel. The JAX function builds
``W2[o, k*Cin + c] = w[k, c, o]`` for its matrix unit; the kernel reads W2
transposed, ``[K*Cin, Cout]``, which is w itself (the source's header says
why), so the wrapper passes w with no copy. The kernel's own limits
(K <= 16, B <= 65535) are checked by its launcher, which refuses a launch
outside them.

No model path calls it: the model's convs run channel-last through
``conv1d_fused``. ``chip_smoke.py`` drives it over the full_44KHz conv shapes
(phase ``im2col``, the counterpart of ``tools/pallas_im2col_bench.py``).
"""

from __future__ import annotations

import torch

from waveunet_tpu_torch.ops.kernels import build

# Kernel launches since the last reset; chip_smoke.py reads it to show which
# runs went through the kernel.
launches = 0

ALPHA = 0.2  # LeakyReLU slope; csrc/conv1d_lrelu_im2col.cu has the same one


def conv1d_lrelu_im2col_plain(x: torch.Tensor, w: torch.Tensor,
                              b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the patch matrix built literally, one matmul."""
    B, Cin, L = x.shape
    K, _, Cout = w.shape
    L_out = L - K + 1
    if L_out < 1:
        raise ValueError(f"input length {L} shorter than filter {K}")
    # patches[b, k*Cin + c, t] = x[b, c, t + k]; W2[o, k*Cin + c] = w[k, c, o]
    patches = x.unfold(2, K, 1).permute(0, 3, 1, 2).reshape(B, K * Cin, L_out)
    w2 = w.permute(2, 0, 1).reshape(Cout, K * Cin)
    y = torch.matmul(w2, patches) + b[:, None]
    return torch.maximum(ALPHA * y, y)


def conv1d_lrelu_im2col_cuda(x: torch.Tensor, w: torch.Tensor,
                             b: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on x's device and its current stream (no
    synchronise)."""
    global launches
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise ValueError(f"conv1d_lrelu_im2col: {name} must be a float32 "
                             f"CUDA tensor, got {t.dtype} on {t.device}")
        if t.device != x.device:
            raise ValueError("conv1d_lrelu_im2col: inputs on different "
                             "devices")
    B, Cin, L = x.shape
    K, w_cin, Cout = w.shape
    L_out = L - K + 1
    if w_cin != Cin or b.shape != (Cout,):
        raise ValueError(f"conv1d_lrelu_im2col: shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)} disagree")
    if L_out < 1:
        raise ValueError(f"input length {L} shorter than filter {K}")
    if not (w.is_contiguous() and b.is_contiguous()):
        raise ValueError("conv1d_lrelu_im2col: w and b must be contiguous")
    y = torch.empty((B, Cout, L_out), device=x.device, dtype=torch.float32)
    lib = build.load()
    with torch.cuda.device(x.device):  # the launcher runs on the current card
        status = lib.conv1d_lrelu_im2col_f32(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), B, L_out,
            Cin, Cout, K, x.stride(0), x.stride(1), x.stride(2),
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, f"conv1d_lrelu_im2col (B={B}, K={K}, {Cin}->{Cout})")
    launches += 1
    return y


def conv1d_lrelu_im2col(x: torch.Tensor, w: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if x.device.type == "cuda":
        return conv1d_lrelu_im2col_cuda(x, w, b)
    if x.device.type != "cpu":
        raise ValueError(f"conv1d_lrelu_im2col: unsupported device "
                         f"{x.device}")
    return conv1d_lrelu_im2col_plain(x, w, b)
