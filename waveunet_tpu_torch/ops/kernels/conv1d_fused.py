"""Fused valid conv1d + bias + LeakyReLU: CUDA kernel, launch planner, plain
version, wrapper.

Counterpart of ``waveunet_tpu/ops/pallas/conv1d_fused.py::conv1d_lrelu_pallas``.
The kernel is ``csrc/conv1d_lrelu.cu``: an implicit GEMM on the tensor cores
in 3xTF32 (its header says what bounds it and how it is tiled).
``conv1d_lrelu`` launches it for a CUDA tensor and takes the plain PyTorch
version only for a CPU tensor.

Shapes: x ``[B, L, Cin]`` (any batch and time stride, channel stride 1, so a
decimated view ``x[:, ::2, :]`` goes in without a copy), w ``[K, Cin, Cout]``
(TF layout), b ``[Cout]`` -> ``[B, L - K + 1, Cout]``, all fp32. The
LeakyReLU slope is the model's 0.2, a constant here and in the kernel.

``plan_launch`` makes the launch's choices in plain Python, so the CPU tests
reach them: the column tile of each launch, the rows a block covers, the
flat reduction of thin inputs, the split of the reduction across blocks for
grids that fill less than a wave, and the dynamic shared memory. The launcher takes the
plan and checks it against the kernel's own limits (K <= 16, the grid's
extents, the slab and shared-memory sizes) before it launches.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from waveunet_tpu_torch.ops.kernels import build, refuse_autograd

# Kernel launches since the last reset; chip_smoke.py reads it to show that
# the main path went through the kernel. A split launch (the GEMM and the
# reduction of its partial sums) counts once.
launches = 0

ALPHA = 0.2  # LeakyReLU slope; csrc/conv1d_lrelu.cu has the same constant

# The kernel's compiled geometry (csrc/conv1d_lrelu.cu has the same numbers).
SMS = 132                      # streaming multiprocessors of an H100 SXM
TILE_M = 128                   # rows (flattened b, t) a block computes
WARP_N = 24                    # columns of one warp: three n8 mma fragments
TILE_NS = (24, 48)             # column tiles: 1 or 2 warp columns
CHUNK = 8                      # input channels per reduction chunk
FLAT_CIN = (2, 4, 6)           # thin inputs reduced over their flat patch row
STAGES = 2                     # cp.async ring depth
MAX_SMEM = 232448              # dynamic shared memory a block may use
SM_SMEM = 233472               # shared memory of one SM, 1 KB of it per block
WARPS_PER_SM = 12              # the kernel's launch bounds: <= 170 registers


class LaunchPlan(NamedTuple):
    tile_m: int            # flattened output rows per block (<= TILE_M)
    tile_n: int            # output channels per block, one of TILE_NS
    m_tiles: int
    n_tiles: int
    flat: bool             # one chunk over the flat K*Cin patch row
    chunk_r: int           # reduction length of one chunk (a multiple of 8)
    chunks: int
    splits: int            # blocks along the reduction
    chunks_per_split: int
    slab_rows: int         # staged input rows per chunk, halo and tail
    smem_bytes: int
    workspace: Optional[Tuple[int, int, int]]  # split partials [S, M, Cout]

    @property
    def grid(self) -> int:
        return self.m_tiles * self.n_tiles * self.splits


def _tile_n(cout: int) -> int:
    """The widest column tile whose padded columns stay under 1/8 of the
    columns computed; else the one that pads least (a Cout under 24)."""
    def pad(t):
        return -cout % t
    fits = [t for t in TILE_NS if 8 * pad(t) < math.ceil(cout / t) * t]
    if fits:
        return max(fits)
    return min(TILE_NS, key=lambda t: (pad(t), -t))


def _batch_rows(tile_m: int, B: int, L_out: int) -> int:
    """The most batch rows that tile_m consecutive flattened rows touch."""
    if tile_m < 2:
        return 1
    return min(B, (tile_m - 2) // L_out + 2)


def _smem(slab_rows: int, lda: int, chunk_r: int, tile_n: int) -> int:
    """Row-offset table (8 bytes a slab row, padded to 16) and the ring:
    slab [slab_rows][lda] padded to 16 bytes, weights [chunk_r][tile_n + 4]."""
    table = -(-slab_rows * 8 // 16) * 16
    slab = -(-slab_rows * lda // 4) * 4
    return table + STAGES * 4 * (slab + chunk_r * (tile_n + 4))


def _resident_blocks(tile_n: int, smem_bytes: int) -> int:
    """Blocks of one launch that an SM holds at once: by registers (two
    warps a warp column) and by shared memory."""
    warps = 2 * tile_n // WARP_N
    return max(1, min(WARPS_PER_SM // warps, SM_SMEM // (smem_bytes + 1024)))


def plan_launch(B: int, L_out: int, Cin: int, Cout: int, K: int,
                time_stride: Optional[int] = None) -> LaunchPlan:
    """Tiles, reduction split and workspace of one launch.

    Rows are the flattened M = B * L_out outputs; a block's input slab holds
    its rows plus K - 1 halo rows for every batch row it touches. A thin
    input (Cin 2, 4 or 6) read with its rows back to back
    (``time_stride == Cin``) is reduced over its flat patch row of K*Cin
    floats in one chunk; any other in chunks of 8 channels and all K taps.
    Where the M x N tiles fill less than 3/4 of one wave of resident
    blocks on the card's SMS multiprocessors (or fewer blocks than SMs),
    the chunks are split across blocks, as evenly as they go, towards two
    waves, and a second pass sums the partials in a fixed order."""
    if time_stride is None:
        time_stride = Cin
    M = B * L_out
    tile_n = _tile_n(Cout)
    flat = Cin in FLAT_CIN and time_stride == Cin
    if flat:
        lda, chunk_r, chunks = Cin, -(-K * Cin // 8) * 8, 1
    else:
        lda, chunk_r, chunks = CHUNK, CHUNK * K, -(-Cin // CHUNK)
    tile_m = TILE_M
    while True:
        # 4 tail rows keep the flat chunk's padded reads inside the slab
        slab_rows = tile_m + (K - 1) * _batch_rows(tile_m, B, L_out) + 4
        smem = _smem(slab_rows, lda, chunk_r, tile_n)
        if smem <= MAX_SMEM or tile_m == 16:
            break
        tile_m //= 2
    m_tiles = -(-M // tile_m)
    n_tiles = -(-Cout // tile_n)
    base = m_tiles * n_tiles
    slots = SMS * _resident_blocks(tile_n, smem)
    splits = 1
    if base < max(SMS, 3 * slots // 4):
        splits = min(chunks, -(-2 * slots // base))
    per_split = -(-chunks // splits)
    splits = -(-chunks // per_split)  # no split left without a chunk
    return LaunchPlan(tile_m, tile_n, m_tiles, n_tiles, flat, chunk_r,
                      chunks, splits, per_split, slab_rows, smem,
                      (splits, M, Cout) if splits > 1 else None)


def conv1d_lrelu_plain(x: torch.Tensor, w: torch.Tensor,
                       b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: one matmul per tap, accumulated in fp32."""
    K = w.shape[0]
    L_out = x.shape[1] - K + 1
    if L_out < 1:
        raise ValueError(f"input length {x.shape[1]} shorter than filter {K}")
    acc = torch.matmul(x[:, 0:L_out, :], w[0])
    for k in range(1, K):
        acc = acc + torch.matmul(x[:, k:k + L_out, :], w[k])
    y = acc + b
    return torch.maximum(ALPHA * y, y)


def conv1d_lrelu_cuda(x: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on x's device and its current stream (no
    synchronise)."""
    global launches
    B, L, Cin = x.shape
    K, w_cin, Cout = w.shape
    L_out = L - K + 1
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise ValueError(f"conv1d_lrelu: {name} must be a float32 CUDA "
                             f"tensor, got {t.dtype} on {t.device}")
        if t.device != x.device:
            raise ValueError("conv1d_lrelu: inputs on different devices")
    if w_cin != Cin or b.shape != (Cout,):
        raise ValueError(f"conv1d_lrelu: shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)} disagree")
    if L_out < 1:
        raise ValueError(f"input length {L} shorter than filter {K}")
    if x.stride(2) != 1:
        raise ValueError("conv1d_lrelu: x needs channel stride 1")
    if not (w.is_contiguous() and b.is_contiguous()):
        raise ValueError("conv1d_lrelu: w and b must be contiguous")
    plan = plan_launch(B, L_out, Cin, Cout, K, x.stride(1))
    y = torch.empty((B, L_out, Cout), device=x.device, dtype=torch.float32)
    ws = (torch.empty(plan.workspace, device=x.device, dtype=torch.float32)
          if plan.workspace else None)
    lib = build.load()
    with torch.cuda.device(x.device):  # the launcher runs on the current card
        status = lib.conv1d_lrelu_f32(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
            ws.data_ptr() if ws is not None else None, B, L_out, Cin, Cout, K,
            x.stride(0), x.stride(1), plan.tile_m, plan.tile_n,
            int(plan.flat), plan.splits, plan.chunks_per_split,
            plan.slab_rows, plan.smem_bytes,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, f"conv1d_lrelu (B={B}, K={K}, {Cin}->{Cout})")
    launches += 1
    return y


def conv1d_lrelu(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor.
    Either way it refuses an input that requires grad under grad mode."""
    refuse_autograd("conv1d_lrelu", x, w, b)
    if x.device.type == "cuda":
        return conv1d_lrelu_cuda(x, w, b)
    if x.device.type != "cpu":
        raise ValueError(f"conv1d_lrelu: unsupported device {x.device}")
    return conv1d_lrelu_plain(x, w, b)
