"""Channel-major fused valid conv1d + bias + LeakyReLU as one GEMM over
K*Cin: CUDA kernel, launch planner, plain version, wrapper.

Counterpart of ``waveunet_tpu/ops/pallas/conv1d_im2col.py:44``
(``conv1d_lrelu_im2col``). The kernel is ``csrc/conv1d_lrelu_im2col.cu``: a
3xTF32 GEMM on the tensor cores (``wgmma``) with time on M and output
channels on N (its header says what bounds it and how it is tiled).
``conv1d_lrelu_im2col`` launches it for a CUDA tensor and takes the plain
PyTorch version only for a CPU tensor.

Shapes: x ``[B, Cin, L]`` (any batch, channel and time stride, so a decimated
view ``x[:, :, ::2]`` goes in without a copy), w ``[K, Cin, Cout]`` (TF
layout, as the JAX function takes it), b ``[Cout]`` ->
``[B, Cout, L - K + 1]``, all fp32. The LeakyReLU slope is the model's 0.2,
a constant here and in the kernel. The JAX function builds
``W2[o, k*Cin + c] = w[k, c, o]`` for its matrix unit; here a preparation
kernel, run by every call, writes W2 split into TF32 hi and lo halves in
the order and layout the GEMM's shared memory takes them, into scratch the
wrapper allocates.

``plan_launch`` makes the launch's choices in plain Python, so the CPU tests
reach them: the column tile, the rows a block covers, the reduction chunks
(8 channels x a group of taps, or the flat patch row of a thin input), the
split of the reduction across blocks for grids that fill less than a wave,
the slab and the dynamic shared memory. The launcher re-checks the plan
against the kernel's own limits (K <= 16, the grid's extents, the slab and
shared-memory sizes) and refuses a launch outside them.

No model path calls it: the model's convs run channel-last through
``conv1d_fused``. ``chip_smoke.py`` drives it over the full_44KHz conv shapes
(phase ``im2col``, the counterpart of ``tools/pallas_im2col_bench.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from waveunet_tpu_torch.ops.kernels import build, refuse_autograd

# Kernel launches since the last reset; chip_smoke.py reads it to show which
# runs went through the kernel. A call (weight preparation, GEMM and, when
# split, the sum of the partials) counts once.
launches = 0

ALPHA = 0.2  # LeakyReLU slope; csrc/conv1d_lrelu_im2col.cu has the same one

# The kernel's compiled geometry (csrc/conv1d_lrelu_im2col.cu has the same
# numbers).
SMS = 132                      # streaming multiprocessors of an H100 SXM
WG_ROWS = 64                   # rows of one warpgroup's wgmma tile
TILE_MS = (128, 64)            # rows a block computes: 2 or 1 warpgroups
TILE_NS = (24, 48, 72, 96)     # columns: the wgmma N of one instruction
TILE_COST = 24                 # a column tile's fixed work, in columns
CHUNK = 8                      # input channels of a reduction chunk
FLAT_MAX_CIN = 4               # thin inputs reduced over their flat patch row
STAGES = 2                     # ring depth
TAIL = 8                       # zero slab rows the flat row's padding reads
W_STAGE_BYTES = 56 * 1024      # most weight bytes a stage's taps may take
MAX_SMEM = 232448              # dynamic shared memory a block may use
SM_SMEM = 233472               # shared memory of one SM, 1 KB of it per block
BLOCKS_PER_SM = 2              # the kernel's launch bounds


class LaunchPlan(NamedTuple):
    tile_m: int            # flattened output rows per block (64 or 128)
    tile_n: int            # output channels per block, one of TILE_NS
    m_tiles: int
    n_tiles: int
    flat: bool             # one chunk over the flat K*Cin patch row
    taps: int              # taps per chunk (K when flat)
    chunk_r: int           # reduction rows of one chunk (a multiple of 8)
    chunks: int
    splits: int            # blocks along the reduction
    chunks_per_split: int
    slab_rows: int         # staged input rows per chunk: halo and tail
    row: int               # floats per slab channel row, 8 mod 32
    smem_bytes: int
    prep_floats: int       # the prepared hi/lo weights
    workspace: Optional[Tuple[int, int, int, int]]  # partials [S, B, Cout, L]

    @property
    def grid(self) -> int:
        return self.m_tiles * self.n_tiles * self.splits


def _tile_n(cout: int) -> int:
    """The column tile of least cost: n_tiles * (tile_n + TILE_COST), the
    A reads and splits of each tile counted as TILE_COST columns; on a tie
    the one that pads least."""
    def cost(t):
        n = -(-cout // t)
        return n * (t + TILE_COST), n * t - cout
    return min(TILE_NS, key=cost)


def _batch_rows(tile_m: int, B: int, L_out: int) -> int:
    """The most batch rows that tile_m consecutive flattened rows touch."""
    return min(B, (tile_m - 2) // L_out + 2)


def _smem(slab_rows: int, row: int, chunk_r: int, tile_n: int) -> int:
    """Row-offset table (8 bytes a slab row, padded to 16), 128 bytes of
    barriers, and the ring: hi and lo weights [chunk_r][tile_n] and the
    slab [8][row] per stage."""
    table = -(-slab_rows * 8 // 16) * 16
    return table + 128 + STAGES * 4 * (2 * chunk_r * tile_n + CHUNK * row)


def plan_launch(B: int, L_out: int, Cin: int, Cout: int,
                K: int) -> LaunchPlan:
    """Tiles, reduction chunks, split and workspace of one launch.

    Rows are the flattened M = B * L_out outputs; a block's input slab holds
    its rows plus K - 1 halo rows for every batch row it touches and TAIL
    zero rows. A thin input (Cin <= 4) is reduced over its flat patch row
    of K*Cin floats, padded to a multiple of 8, in one chunk; any other in
    chunks of 8 channels and a group of taps, the K taps cut into as few
    equal groups as keep a stage's hi and lo weights within W_STAGE_BYTES.
    Where the M x N tiles fill less than 3/4 of one wave of resident blocks
    (or fewer blocks than SMs), the chunks are split across blocks, as
    evenly as they go, towards two waves, and a second pass sums the
    partials in a fixed order."""
    M = B * L_out
    tile_n = _tile_n(Cout)
    flat = Cin <= FLAT_MAX_CIN
    if flat:
        taps, chunk_r, chunks = K, -(-K * Cin // 8) * 8, 1
    else:
        most = max(1, W_STAGE_BYTES // (2 * 4 * CHUNK * tile_n))
        groups = -(-K // most)
        taps = -(-K // groups)
        chunk_r = CHUNK * taps
        chunks = -(-Cin // CHUNK) * groups
    for tile_m in TILE_MS:
        slab_rows = tile_m + (K - 1) * _batch_rows(tile_m, B, L_out) + TAIL
        row = slab_rows + (8 - slab_rows) % 32
        smem = _smem(slab_rows, row, chunk_r, tile_n)
        if smem <= MAX_SMEM:
            break
    m_tiles = -(-M // tile_m)
    n_tiles = -(-Cout // tile_n)
    base = m_tiles * n_tiles
    resident = max(1, min(BLOCKS_PER_SM, SM_SMEM // (smem + 1024)))
    slots = SMS * resident
    splits = 1
    if base < max(SMS, 3 * slots // 4):
        splits = min(chunks, -(-2 * slots // base))
    per_split = -(-chunks // splits)
    splits = -(-chunks // per_split)  # no split left without a chunk
    return LaunchPlan(tile_m, tile_n, m_tiles, n_tiles, flat, taps, chunk_r,
                      chunks, splits, per_split, slab_rows, row, smem,
                      n_tiles * chunks * 2 * chunk_r * tile_n,
                      (splits, B, Cout, L_out) if splits > 1 else None)


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
    plan = plan_launch(B, L_out, Cin, Cout, K)
    y = torch.empty((B, Cout, L_out), device=x.device, dtype=torch.float32)
    wp = torch.empty(plan.prep_floats, device=x.device, dtype=torch.float32)
    ws = (torch.empty(plan.workspace, device=x.device, dtype=torch.float32)
          if plan.workspace else None)
    lib = build.load()
    with torch.cuda.device(x.device):  # the launcher runs on the current card
        status = lib.conv1d_lrelu_im2col_f32(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
            wp.data_ptr(), ws.data_ptr() if ws is not None else None, B,
            L_out, Cin, Cout, K, x.stride(0), x.stride(1), x.stride(2),
            plan.tile_m, plan.tile_n, int(plan.flat), plan.taps, plan.splits,
            plan.chunks_per_split, plan.slab_rows, plan.row, plan.smem_bytes,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, f"conv1d_lrelu_im2col (B={B}, K={K}, {Cin}->{Cout})")
    launches += 1
    return y


def conv1d_lrelu_im2col(x: torch.Tensor, w: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor.
    Either way it refuses an input that requires grad under grad mode."""
    refuse_autograd("conv1d_lrelu_im2col", x, w, b)
    if x.device.type == "cuda":
        return conv1d_lrelu_im2col_cuda(x, w, b)
    if x.device.type != "cpu":
        raise ValueError(f"conv1d_lrelu_im2col: unsupported device "
                         f"{x.device}")
    return conv1d_lrelu_im2col_plain(x, w, b)
