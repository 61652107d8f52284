"""The arithmetic and the launch plan of the conv kernel, on the CPU.

``csrc/conv1d_lrelu.cu`` computes on the tensor cores in 3xTF32: each operand
is split into hi + lo, both rounded to TF32 as ``cvt.rna.tf32.f32`` rounds,
and hi*hi + hi*lo + lo*hi is summed in fresh fp32 fragments of 16 reduction
rows, each added to an fp32 total, chunk by chunk of the reduction in the
order ``plan_launch`` gives the kernel, with the split partials summed in
split order. The kernel runs only on the card
(chip_smoke.py holds it against its plain version there); here an emulation
of that arithmetic, in this file only, is held against the JAX package's
Pallas kernel in interpret mode at the kernel tests' tolerance, and one TF32
product alone is shown to miss it. The planner the wrapper launches with is
checked over every conv launch of full_44KHz.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from waveunet_tpu.config import get_config as jax_get_config
from waveunet_tpu.models.waveunet import apply_waveunet as jax_apply
from waveunet_tpu.ops.pallas.conv1d_fused import conv1d_lrelu_pallas

from waveunet_tpu_torch.compat.params import params_from_numpy
from waveunet_tpu_torch.config import get_config
from waveunet_tpu_torch.models import waveunet as model
from waveunet_tpu_torch.ops.kernels import conv1d_fused
from waveunet_tpu_torch.ops.kernels.conv1d_fused import plan_launch

KERNEL_ATOL = 1e-5   # tests/test_torch_kernels.py: fp32 sums in another order
FORWARD_ATOL = 2e-5  # the reference's forward tolerance (tests/test_compat.py)

# The four main-path conv shapes of full_44KHz: Cin, Cout, K, decimated view
MAIN_SHAPES = {
    "down_0": (2, 24, 15, False),
    "down_11": (264, 288, 15, True),
    "bottleneck": (288, 312, 15, True),
    "up_0": (600, 288, 5, False),
}


def tf32(a):
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as cvt.rna does: on the bit pattern."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(a):
    hi = tf32(a)
    return hi, tf32(a - hi)


def chunks(plan, K, Cin):
    """The reduction rows r = k * Cin + c of each chunk, in the kernel's
    order: the whole flat patch row, or 8 channels over all K taps."""
    if plan.flat:
        return [np.arange(K * Cin)]
    return [np.array([k * Cin + c for k in range(K)
                      for c in range(8 * i, min(8 * i + 8, Cin))])
            for i in range(plan.chunks)]


def emulated_conv(x, w, b, products=3):
    """conv1d + bias + LeakyReLU in the kernel's arithmetic, for x
    [B, L, Cin] (numpy, any strides), w [K, Cin, Cout], b [Cout]. Products
    3 is 3xTF32; 1 is a single TF32 product."""
    B, L, Cin = x.shape
    K, _, Cout = w.shape
    L_out = L - K + 1
    plan = plan_launch(B, L_out, Cin, Cout, K, x.strides[1] // x.itemsize)
    patches = np.concatenate([x[:, k:k + L_out] for k in range(K)], axis=2)
    a = patches.reshape(B * L_out, K * Cin).astype(np.float32)
    w2 = w.reshape(K * Cin, Cout).astype(np.float32)
    parts = []
    rows = chunks(plan, K, Cin)
    for s in range(plan.splits):
        acc = np.zeros((B * L_out, Cout), np.float32)
        for chunk in rows[s * plan.chunks_per_split:
                          (s + 1) * plan.chunks_per_split]:
            # the kernel adds a fresh fragment to acc every two k8 steps
            for g in range(0, len(chunk), 16):
                r = chunk[g:g + 16]
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
    y = (total + b).reshape(B, L_out, Cout)
    return np.maximum(np.float32(0.2) * y, y)


def _inputs(rng, L, K, cin, cout, decimated):
    full = rng.standard_normal((2, 2 * L - 1 if decimated else L, cin)).astype(
        np.float32)
    x = full[:, ::2] if decimated else full
    lim = np.sqrt(6.0 / (K * (cin + cout)))
    w = rng.uniform(-lim, lim, (K, cin, cout)).astype(np.float32)
    b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    return x, w, b


def _pallas(x, w, b):
    return np.asarray(conv1d_lrelu_pallas(
        jnp.asarray(np.ascontiguousarray(x)), jnp.asarray(w), jnp.asarray(b),
        tile_l=64, interpret=True))


@pytest.mark.parametrize("shape", sorted(MAIN_SHAPES))
def test_3xtf32_matches_pallas_and_1xtf32_does_not(rng, shape):
    cin, cout, K, decimated = MAIN_SHAPES[shape]
    # L_out = 211 - K + 1: no multiple of the Pallas tile (64), ragged tail
    x, w, b = _inputs(rng, 211, K, cin, cout, decimated)
    want = _pallas(x, w, b)
    got = emulated_conv(x, w, b)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=KERNEL_ATOL)
    one = emulated_conv(x, w, b, products=1)
    assert np.abs(one - want).max() > KERNEL_ATOL


@pytest.mark.parametrize("cin,cout,K,L", [
    (1, 1, 15, 40),     # mono input, one output channel
    (3, 34, 5, 60),     # unaligned rows, masked columns
    (34, 34, 1, 50),    # K = 1 merge conv, baseline_comparison's width
    (6, 48, 16, 70),    # flat chunk, widest filter
    (40, 72, 16, 80),   # several chunks, split
])
def test_3xtf32_matches_pallas_at_the_edges(rng, cin, cout, K, L):
    x, w, b = _inputs(rng, L, K, cin, cout, False)
    np.testing.assert_allclose(emulated_conv(x, w, b), _pallas(x, w, b),
                               atol=KERNEL_ATOL)


def test_small_forward_in_3xtf32_matches_jax(monkeypatch):
    """full_44KHz at 4 layers and 8 filters, every conv + LeakyReLU in the
    kernel's arithmetic, against the JAX package's forward."""
    from tests.test_torch_model import numpy_params

    kw = dict(num_layers=4, num_initial_filters=8, num_frames=1024)
    jcfg, cfg = jax_get_config("full_44KHz", **kw), get_config(
        "full_44KHz", **kw)
    in_len, _ = model.io_shapes(cfg)
    params = numpy_params(cfg)
    mix = (0.5 * np.random.default_rng(1).standard_normal(
        (2, in_len, cfg.num_channels))).astype(np.float32)
    want = jax_apply(jax.tree_util.tree_map(jnp.asarray, params), jcfg,
                     jnp.asarray(mix), training=False)

    def conv(x, w, b):
        return torch.from_numpy(emulated_conv(x.numpy(), w.numpy(),
                                              b.numpy()))

    monkeypatch.setattr(model, "conv1d_lrelu", conv)
    got = model.apply_waveunet(params_from_numpy(params, "cpu"), cfg,
                               torch.from_numpy(mix))
    for name in cfg.source_names:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=FORWARD_ATOL, err_msg=name)


def full_44khz_launches(batch):
    """(B, L_out, Cin, Cout, K, x time stride) of every conv launch of one
    full_44KHz forward of ``batch`` windows, recorded from the model's own
    forward on shape-only tensors."""
    cfg = get_config("full_44KHz")
    from waveunet_tpu_torch.infer.engine import Separator
    params = model.init_waveunet(torch.Generator().manual_seed(0), cfg, "cpu")
    in_len = Separator(cfg, params, device="cpu").in_len
    meta = {layer: {n: t.to("meta") for n, t in leaves.items()}
            for layer, leaves in params.items()}
    seen = []

    def conv(x, w, b):
        K, cin, cout = w.shape
        L_out = x.shape[1] - K + 1
        seen.append((x.shape[0], L_out, cin, cout, K, x.stride(1)))
        return torch.empty((x.shape[0], L_out, cout), device="meta")

    def interp(x, w, context):
        n = 2 * x.shape[1] - 1 if context else 2 * x.shape[1]
        return torch.empty((x.shape[0], n, x.shape[2]), device="meta")

    def out_conv(x, p, padding, compute_dtype=None):
        return torch.empty(x.shape[:2] + (p["kernel"].shape[2],),
                           device="meta")

    mp = pytest.MonkeyPatch()
    with mp.context() as m:
        m.setattr(model, "conv1d_lrelu", conv)
        m.setattr(model, "learned_interp", interp)
        m.setattr(model, "conv1d", out_conv)
        model._forward(meta, cfg, torch.empty((batch, in_len, 2),
                                              device="meta"))
    return seen


@pytest.mark.parametrize("batch", [16, 1])
def test_plan_covers_every_full_44khz_launch(batch):
    seen = full_44khz_launches(batch)
    assert len(seen) == 25
    assert sum(2 * B * L * K * ci * co for B, L, ci, co, K, _ in seen) == (
        batch * 37_480_430_880)  # 37.48 GFLOP a window (PERF.md section 4)
    for B, L_out, cin, cout, K, stride in seen:
        plan = plan_launch(B, L_out, cin, cout, K, stride)
        what = (B, L_out, cin, cout, K, plan)
        computed = plan.n_tiles * plan.tile_n
        assert 8 * (computed - cout) < computed, what  # padding under 1/8
        assert plan.grid >= 132 or plan.chunks_per_split == 1, what
        assert plan.splits * plan.chunks_per_split >= plan.chunks, what
        assert (plan.splits - 1) * plan.chunks_per_split < plan.chunks, what
        want_ws = (plan.splits, B * L_out, cout) if plan.splits > 1 else None
        assert plan.workspace == want_ws, what
        assert plan.smem_bytes <= conv1d_fused.MAX_SMEM, what
        assert plan.m_tiles * plan.tile_m >= B * L_out, what
        # the thin first layer reads its flat patch row (30 -> 32)
        assert plan.flat == (cin == 2), what
    if batch == 16:  # the deep layers split; the wide ones need not
        splits = [plan_launch(*s[:5], s[5]).splits for s in seen]
        assert splits[0] == 1 and max(splits) > 1


@pytest.mark.parametrize("B,L_out,K", [(16, 1, 16), (256, 1, 16),
                                       (16, 21, 15), (1, 100000, 15)])
def test_plan_slab_holds_the_halo_of_every_batch_row(B, L_out, K):
    """The slab of any tile_m consecutive rows fits its allotted rows, and
    shared memory stays within the block's limit (tile_m shrinks if not)."""
    plan = plan_launch(B, L_out, 264, 288, K, 2 * 264)
    assert plan.smem_bytes <= conv1d_fused.MAX_SMEM
    M = B * L_out
    for m0 in range(0, M, max(1, plan.tile_m // 3)):
        rows = min(plan.tile_m, M - m0)
        touched = (m0 + rows - 1) // L_out - m0 // L_out + 1
        assert rows + (K - 1) * touched + 4 <= plan.slab_rows


def test_plan_flat_only_for_thin_rows_back_to_back():
    assert plan_launch(2, 100, 2, 24, 15).flat
    assert not plan_launch(2, 100, 2, 24, 15, time_stride=4).flat  # view
    assert not plan_launch(2, 100, 3, 24, 15).flat  # odd: 8-channel chunk
    assert plan_launch(2, 100, 2, 24, 15).chunk_r == 32  # 30 padded to 32
    assert plan_launch(2, 100, 24, 48, 15).chunk_r == 120


@pytest.mark.parametrize("cout,tile_n", [(24, 24), (72, 24), (120, 24),
                                         (168, 24), (216, 48), (264, 48),
                                         (312, 48), (34, 48), (1, 24)])
def test_plan_column_tile(cout, tile_n):
    assert plan_launch(16, 1000, 48, cout, 15, 48).tile_n == tile_n
