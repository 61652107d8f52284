"""The arithmetic and the launch plan of the im2col conv kernel, on the CPU.

``csrc/conv1d_lrelu_im2col.cu`` computes on the tensor cores (wgmma) in
3xTF32: each operand is split into hi + lo, both rounded to TF32 as
``cvt.rna.tf32.f32`` rounds, and lo*hi + hi*lo + hi*hi is summed in fresh
fp32 accumulators over two k8 steps (one tap of 8 channels a step, or 8 rows
of a thin input's flat patch row), each added to an fp32 total, chunk by
chunk of the reduction in the order ``plan_launch`` gives the kernel, with
the split partials summed in split order. The kernel runs only on the card
(chip_smoke.py holds it against its plain version there); here an emulation
of that arithmetic, in this file only, is held against the JAX package's
Pallas kernel in interpret mode at the kernel tests' tolerance, and one TF32
product alone is shown to miss it. The weight layout the preparation kernel
writes is checked against the reads of the GEMM's k8 steps, and the planner
over every full_44KHz shape the kernel is driven at.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from waveunet_tpu.ops.pallas.conv1d_im2col import (
    conv1d_lrelu_im2col as jax_im2col)

import chip_smoke
from tests.test_torch_conv_tf32 import full_44khz_launches, split
from waveunet_tpu_torch.config import get_config
from waveunet_tpu_torch.ops import shapes
from waveunet_tpu_torch.ops.kernels import conv1d_im2col
from waveunet_tpu_torch.ops.kernels.conv1d_im2col import plan_launch

KERNEL_ATOL = 1e-5  # tests/test_torch_im2col.py: fp32 sums in another order

# Channel-major counterparts of the four main-path conv shapes of
# full_44KHz: Cin, Cout, K, decimated view
MAIN_SHAPES = {
    "down_0": (2, 24, 15, False),
    "down_11": (264, 288, 15, True),
    "bottleneck": (288, 312, 15, True),
    "up_0": (600, 288, 5, False),
}


def chunk_steps(plan, K, Cin):
    """The reduction rows r = k * Cin + c of each chunk, as the kernel's k8
    steps of 8 rows each (-1: a zero row), in the kernel's order: a flat
    chunk is the patch row padded to chunk_r; a chunk of 8 channels steps
    through its group of taps, one tap of 8 channels a step."""
    if plan.flat:
        rows = [r if r < K * Cin else -1 for r in range(plan.chunk_r)]
        return [[rows[i:i + 8] for i in range(0, plan.chunk_r, 8)]]
    groups = -(-K // plan.taps)
    out = []
    for ch in range(plan.chunks):
        c0, k0 = (ch // groups) * 8, (ch % groups) * plan.taps
        out.append([[k * Cin + c if c < Cin else -1 for c in range(c0, c0 + 8)]
                    for k in range(k0, min(K, k0 + plan.taps))])
    return out


def emulated_im2col(x, w, b, products=3):
    """conv1d + bias + LeakyReLU in the kernel's arithmetic, for x
    [B, Cin, L] (numpy, any strides), w [K, Cin, Cout], b [Cout]. Products
    3 is 3xTF32; 1 is a single TF32 product."""
    B, Cin, L = x.shape
    K, _, Cout = w.shape
    L_out = L - K + 1
    plan = plan_launch(B, L_out, Cin, Cout, K)
    # patch matrix [M, K*Cin] with a zero column last for padded rows
    patches = np.concatenate([x[:, :, k:k + L_out] for k in range(K)], axis=1)
    a = patches.transpose(0, 2, 1).reshape(B * L_out, K * Cin)
    a = np.concatenate([a, np.zeros((B * L_out, 1))], axis=1).astype(
        np.float32)
    w2 = np.concatenate([w.reshape(K * Cin, Cout), np.zeros((1, Cout))],
                        axis=0).astype(np.float32)
    steps = chunk_steps(plan, K, Cin)
    parts = []
    for s in range(plan.splits):
        acc = np.zeros((B * L_out, Cout), np.float32)
        for chunk in steps[s * plan.chunks_per_split:
                           (s + 1) * plan.chunks_per_split]:
            # fresh accumulators every two k8 steps, added to the total
            for g in range(0, len(chunk), 2):
                r = np.array(sum(chunk[g:g + 2], []))
                a_hi, a_lo = split(a[:, r])
                w_hi, w_lo = split(w2[r])
                if products == 3:
                    part = a_lo @ w_hi + a_hi @ w_lo + a_hi @ w_hi
                else:
                    part = a_hi @ w_hi
                acc = acc + part.astype(np.float32)
        parts.append(acc)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    y = (total + b).reshape(B, L_out, Cout).transpose(0, 2, 1)
    return np.maximum(np.float32(0.2) * y, y)


def _inputs(rng, B, L, K, cin, cout, decimated):
    full = rng.standard_normal(
        (B, cin, 2 * L - 1 if decimated else L)).astype(np.float32)
    x = full[:, :, ::2] if decimated else full
    lim = np.sqrt(6.0 / (K * (cin + cout)))
    w = rng.uniform(-lim, lim, (K, cin, cout)).astype(np.float32)
    b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    return x, w, b


def _pallas(x, w, b):
    return np.asarray(jax_im2col(jnp.asarray(np.ascontiguousarray(x)),
                                 jnp.asarray(w), jnp.asarray(b),
                                 tile_l=128, interpret=True))


@pytest.mark.parametrize("shape", sorted(MAIN_SHAPES))
def test_3xtf32_matches_pallas_and_1xtf32_does_not(rng, shape):
    cin, cout, K, decimated = MAIN_SHAPES[shape]
    # B 3 and L_out 150 - K + 1: no multiple of the Pallas tile (128) and,
    # at the deep shapes, tiles that cross batch rows and split the chunks
    x, w, b = _inputs(rng, 3, 150, K, cin, cout, decimated)
    want = _pallas(x, w, b)
    got = emulated_im2col(x, w, b)
    assert got.shape == want.shape == (3, cout, 150 - K + 1)
    np.testing.assert_allclose(got, want, atol=KERNEL_ATOL)
    one = emulated_im2col(x, w, b, products=1)
    assert np.abs(one - want).max() > KERNEL_ATOL


@pytest.mark.parametrize("cin,cout,K,L", [
    (1, 24, 15, 60),    # mono input: flat row of 15 padded to 16
    (3, 34, 5, 40),     # flat row of 15, masked columns
    (34, 1, 15, 50),    # a ragged 8-channel chunk, one output channel
    (34, 34, 1, 30),    # K = 1 merge conv
    (40, 72, 16, 70),   # widest filter: taps in groups, split
    (24, 96, 16, 33),   # tile_n 96
])
def test_3xtf32_matches_pallas_at_the_edges(rng, cin, cout, K, L):
    x, w, b = _inputs(rng, 2, L, K, cin, cout, False)
    np.testing.assert_allclose(emulated_im2col(x, w, b), _pallas(x, w, b),
                               atol=KERNEL_ATOL)


def prepared_weights(w, plan):
    """What prep_weights_kernel writes, element by element as its index
    decodes: [n_tile][chunk][hi, lo][q / 4][n][q % 4]."""
    K, Cin, Cout = w.shape
    groups = -(-K // plan.taps)
    i = np.arange(plan.prep_floats)
    n = (i // 4) % plan.tile_n
    rest = i // 4 // plan.tile_n
    q = (rest % (plan.chunk_r // 4)) * 4 + i % 4
    rest //= plan.chunk_r // 4
    half = rest % 2
    ch = (rest // 2) % plan.chunks
    o = (rest // 2 // plan.chunks) * plan.tile_n + n
    if plan.flat:
        k, c = q // Cin, q % Cin
    else:
        c, k = (ch // groups) * 8 + (q & 7), (ch % groups) * plan.taps + (q >> 3)
    ok = (o < Cout) & (k < K) & (c < Cin)
    v = np.where(ok, w[np.minimum(k, K - 1), np.minimum(c, Cin - 1),
                       np.minimum(o, Cout - 1)], 0).astype(np.float32)
    hi, lo = split(v)
    return np.where(half == 0, hi, lo)


@pytest.mark.parametrize("B,L_out,cin,cout,K", [
    (2, 50, 2, 24, 15),     # flat
    (2, 50, 20, 72, 15),    # taps in groups, a ragged chunk
    (2, 50, 16, 96, 5),
    (2, 50, 9, 34, 16),
])
def test_prepared_weights_are_what_each_k8_step_reads(rng, B, L_out, cin,
                                                      cout, K):
    """Each k8 step j of a chunk reads B (reduction column q, output column
    n) at core matrix 2j + q / 4, row n, element q % 4 of the stage's hi and
    lo blocks (LBO tile_n * 16 bytes, SBO 128 bytes); hi + lo of what it
    reads is the weight of that step's reduction row, zero past Cin, K and
    Cout."""
    w = rng.standard_normal((K, cin, cout)).astype(np.float32)
    plan = plan_launch(B, L_out, cin, cout, K)
    wp = prepared_weights(w, plan)
    w2 = np.concatenate([w.reshape(K * cin, cout), np.zeros((1, cout))])
    block = 2 * plan.chunk_r * plan.tile_n
    for nt in range(plan.n_tiles):
        for ch, steps in enumerate(chunk_steps(plan, K, cin)):
            stage = wp[(nt * plan.chunks + ch) * block:][:block]
            for j, rows in enumerate(steps):
                for q, r in enumerate(rows):
                    at = ((2 * j + q // 4) * plan.tile_n
                          + np.arange(plan.tile_n)) * 4 + q % 4
                    got = (stage[at].astype(np.float64)
                           + stage[plan.chunk_r * plan.tile_n + at])
                    o = nt * plan.tile_n + np.arange(plan.tile_n)
                    want = np.where(o < cout, w2[r, np.minimum(o, cout - 1)],
                                    0)
                    np.testing.assert_allclose(got, want, rtol=2e-7,
                                               atol=0)


def _tool_shapes():
    cfg = get_config("full_44KHz")
    in_len, _ = shapes.get_padding(cfg, cfg.num_frames)
    return [(16, L - K + 1, cin, cout, K)
            for _, L, K, cin, cout in chip_smoke.im2col_tool_shapes(cfg,
                                                                    in_len)]


def _check_plan(B, L_out, cin, cout, K):
    plan = plan_launch(B, L_out, cin, cout, K)
    what = (B, L_out, cin, cout, K, plan)
    M = B * L_out
    assert plan.smem_bytes <= conv1d_im2col.MAX_SMEM, what
    # two blocks an SM (the kernel's launch bounds) fit in shared memory
    assert 2 * (plan.smem_bytes + 1024) <= conv1d_im2col.SM_SMEM, what
    assert plan.m_tiles * plan.n_tiles < 2 ** 31 and plan.splits <= 65535
    assert plan.m_tiles * plan.tile_m >= M and plan.tile_m in (64, 128), what
    assert plan.n_tiles * plan.tile_n >= cout, what
    assert plan.tile_n in conv1d_im2col.TILE_NS, what
    assert plan.splits * plan.chunks_per_split >= plan.chunks, what
    assert (plan.splits - 1) * plan.chunks_per_split < plan.chunks, what
    # a split only where the tiles fill under a wave of resident blocks
    if plan.splits > 1:
        assert plan.m_tiles * plan.n_tiles < 2 * conv1d_im2col.SMS, what
    # the flat reduction only for thin rows
    assert plan.flat == (cin <= conv1d_im2col.FLAT_MAX_CIN), what
    assert plan.chunk_r % 8 == 0 and plan.row % 32 == 8, what
    assert plan.row >= plan.slab_rows, what
    want_ws = (plan.splits, B, cout, L_out) if plan.splits > 1 else None
    assert plan.workspace == want_ws, what
    return plan


def test_plan_covers_the_tool_shapes():
    plans = [_check_plan(*s) for s in _tool_shapes()]
    assert len(plans) == 12
    assert plans[0].flat and plans[0].chunk_r == 32  # 30 padded to 32
    assert plans[0].splits == 1 and max(p.splits for p in plans) > 1
    # every full_44KHz Cout is a multiple of 24 and pads under 1/4
    for p, (_, _, _, cout, _) in zip(plans, _tool_shapes()):
        assert 4 * (p.n_tiles * p.tile_n - cout) < p.n_tiles * p.tile_n


@pytest.mark.parametrize("batch", [16, 1])
def test_plan_covers_every_full_44khz_forward_launch(batch):
    seen = full_44khz_launches(batch)
    assert len(seen) == 25
    plans = [_check_plan(B, L_out, cin, cout, K)
             for B, L_out, cin, cout, K, _ in seen]
    if batch == 16:  # the deep layers split; the wide ones need not
        assert plans[0].splits == 1 and max(p.splits for p in plans) > 1


@pytest.mark.parametrize("B,L_out,K", [(16, 1, 16), (256, 1, 16),
                                       (16, 21, 15), (1, 100000, 15)])
def test_plan_slab_holds_the_halo_of_every_batch_row(B, L_out, K):
    """The slab of any tile_m consecutive rows fits its allotted rows with
    the tail, and shared memory stays within the block's limit (tile_m
    halves if not)."""
    plan = plan_launch(B, L_out, 264, 288, K)
    assert plan.smem_bytes <= conv1d_im2col.MAX_SMEM
    M = B * L_out
    for m0 in range(0, M, max(1, plan.tile_m // 3)):
        rows = min(plan.tile_m, M - m0)
        touched = (m0 + rows - 1) // L_out - m0 // L_out + 1
        assert rows + (K - 1) * touched + conv1d_im2col.TAIL <= plan.slab_rows


@pytest.mark.parametrize("cout,tile_n", [(24, 24), (48, 48), (72, 72),
                                         (96, 96), (120, 72), (168, 96),
                                         (240, 48), (288, 96), (312, 72),
                                         (34, 48), (1, 24)])
def test_plan_column_tile(cout, tile_n):
    assert plan_launch(16, 1000, 48, cout, 15).tile_n == tile_n


def test_plan_taps_keep_a_stage_within_its_budget():
    """The K taps go in as few equal groups as keep a stage's hi and lo
    weights within W_STAGE_BYTES; a flat chunk takes the whole patch row."""
    for cout in (24, 48, 72, 96):
        plan = plan_launch(16, 1000, 48, cout, 15)
        groups = -(-15 // plan.taps)
        assert 2 * 4 * plan.chunk_r * plan.tile_n <= \
            conv1d_im2col.W_STAGE_BYTES
        assert plan.taps == -(-15 // groups)
        if groups > 1:  # one group fewer would not fit
            wider = -(-15 // (groups - 1))
            assert 2 * 4 * 8 * wider * plan.tile_n > \
                conv1d_im2col.W_STAGE_BYTES
        assert plan.chunks == 6 * groups
    flat = plan_launch(16, 1000, 2, 24, 15)
    assert (flat.taps, flat.chunks, flat.chunk_r) == (15, 1, 32)
