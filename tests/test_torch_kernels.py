"""The port's kernel modules and ops against the JAX package, on the CPU.

Each plain PyTorch version of a hand-written CUDA kernel is held against the
Pallas kernel it replaces, run in interpret mode as tests/test_pallas.py runs
it, on the same numpy inputs. Tolerance 1e-5: both sides compute in fp32
(TF32 off), and only the order of the sums differs. The CUDA kernels
themselves are held against these plain versions on the card by
chip_smoke.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from waveunet_tpu.ops.conv import conv1d as jax_conv1d
from waveunet_tpu.ops.pallas.conv1d_fused import conv1d_lrelu_pallas
from waveunet_tpu.ops.pallas.interp import learned_interp_pallas
from waveunet_tpu.ops.primitives import crop as jax_crop
from waveunet_tpu.ops.resample import resample as jax_resample
from waveunet_tpu.ops.upsample import bilinear_x2 as jax_bilinear_x2

from waveunet_tpu_torch.ops.conv import conv1d, precision_scope
from waveunet_tpu_torch.ops.kernels import conv1d_fused, conv1d_im2col, interp
from waveunet_tpu_torch.ops.primitives import crop
from waveunet_tpu_torch.ops.resample import resample
from waveunet_tpu_torch.ops.upsample import bilinear_x2

KERNEL_ATOL = 1e-5


def _conv_inputs(rng, L, K, cin, cout):
    x = rng.standard_normal((2, L, cin)).astype(np.float32)
    lim = np.sqrt(6.0 / (K * (cin + cout)))
    w = rng.uniform(-lim, lim, (K, cin, cout)).astype(np.float32)
    b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("K", [15, 5])
@pytest.mark.parametrize("cin", [2, 7, 40])
def test_conv1d_lrelu_plain_matches_pallas(rng, K, cin):
    # L_out = 301 - K + 1 is no multiple of the Pallas tile (64): ragged tail
    x, w, b = _conv_inputs(rng, 301, K, cin, 24)
    want = conv1d_lrelu_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               tile_l=64, interpret=True)
    got = conv1d_fused.conv1d_lrelu_plain(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=KERNEL_ATOL)


@pytest.mark.parametrize("context", [True, False])
def test_learned_interp_plain_matches_pallas(rng, context):
    x = rng.standard_normal((2, 101, 12)).astype(np.float32)
    w = rng.standard_normal(12).astype(np.float32)
    want = learned_interp_pallas(jnp.asarray(x), jnp.asarray(w), context,
                                 tile=32, interpret=True)
    got = interp.learned_interp_plain(torch.from_numpy(x), torch.from_numpy(w),
                                      context)
    assert got.shape == want.shape == (2, 201 if context else 202, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=KERNEL_ATOL)


def test_wrappers_take_plain_version_on_cpu_without_launching(rng):
    x, w, b = _conv_inputs(rng, 64, 5, 8, 16)
    xt, wt, bt = map(torch.from_numpy, (x, w, b))
    before = (conv1d_fused.launches, interp.launches)
    y = conv1d_fused.conv1d_lrelu(xt, wt, bt)
    torch.testing.assert_close(y, conv1d_fused.conv1d_lrelu_plain(xt, wt, bt),
                               rtol=0, atol=0)
    u = interp.learned_interp(y, bt, True)
    torch.testing.assert_close(u, interp.learned_interp_plain(y, bt, True),
                               rtol=0, atol=0)
    assert (conv1d_fused.launches, interp.launches) == before


def test_conv_wrapper_reads_a_decimated_view(rng):
    """The model hands the conv a strided x[:, ::2] view (no copy)."""
    x, w, b = _conv_inputs(rng, 129, 15, 6, 12)
    xt = torch.from_numpy(x)
    view = xt[:, ::2, :]
    assert not view.is_contiguous()
    got = conv1d_fused.conv1d_lrelu(view, torch.from_numpy(w),
                                    torch.from_numpy(b))
    want = conv1d_lrelu_pallas(jnp.asarray(x[:, ::2]), jnp.asarray(w),
                               jnp.asarray(b), tile_l=64, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=KERNEL_ATOL)


@pytest.mark.parametrize("wrapper,args", [
    ("conv", lambda t: (t, torch.zeros(3, 2, 4), torch.zeros(4))),
    ("interp", lambda t: (t, torch.zeros(2), True)),
    ("im2col", lambda t: (t.transpose(1, 2), torch.zeros(3, 2, 4),
                          torch.zeros(4))),
])
def test_cuda_entry_refuses_host_tensors(wrapper, args):
    """The launch path never takes a CPU tensor: it raises before building."""
    x = torch.zeros(1, 8, 2)
    fn = {"conv": conv1d_fused.conv1d_lrelu_cuda,
          "interp": interp.learned_interp_cuda,
          "im2col": conv1d_im2col.conv1d_lrelu_im2col_cuda}[wrapper]
    with pytest.raises(ValueError, match="CUDA"):
        fn(*args(x))


@pytest.mark.parametrize("padding,stride,dil,width", [
    ("VALID", 1, 1, 1), ("VALID", 1, 1, 15), ("SAME", 1, 1, 15),
    ("SAME", 1, 1, 6), ([(4, 6)], 2, 2, 6), ("VALID", 2, 2, 5)])
def test_conv1d_matches_jax(rng, padding, stride, dil, width):
    x = rng.standard_normal((2, 77, 5)).astype(np.float32)
    k = (0.3 * rng.standard_normal((width, 5, 3))).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    want = jax_conv1d(jnp.asarray(x), {"kernel": jnp.asarray(k),
                                       "bias": jnp.asarray(b)},
                      padding=padding, stride=stride, rhs_dilation=dil,
                      precision=None)
    with precision_scope(None):
        got = conv1d(torch.from_numpy(x), {"kernel": torch.from_numpy(k),
                                           "bias": torch.from_numpy(b)},
                     padding=padding, stride=stride, rhs_dilation=dil)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_precision_scope_sets_and_restores_tf32():
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    with precision_scope(None):
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    with precision_scope("high"):  # JAX's HIGH is finer than TF32
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    with precision_scope("default"):
        assert torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == prev


@pytest.mark.parametrize("context", [True, False])
def test_bilinear_matches_jax(rng, context):
    x = rng.standard_normal((2, 33, 4)).astype(np.float32)
    want = jax_bilinear_x2(jnp.asarray(x), context)
    got = bilinear_x2(torch.from_numpy(x), context)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("target", [10, 9, 8])
def test_crop_odd_difference_matches_jax(target):
    x = np.arange(2 * 13 * 3, dtype=np.float32).reshape(2, 13, 3)
    np.testing.assert_array_equal(crop(torch.from_numpy(x), target).numpy(),
                                  np.asarray(jax_crop(jnp.asarray(x), target)))


@pytest.mark.parametrize("rates", [(44100, 22050), (22050, 44100),
                                   (48000, 44100)])
def test_resample_matches_jax_package(rng, rates):
    x = (0.3 * rng.standard_normal((4000, 2))).astype(np.float32)
    want = jax_resample(x, *rates)
    got = resample(x, *rates)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("context", [True, False])
def test_chip_smoke_library_yardsticks_match_plain_versions(rng, context):
    """The single PyTorch calls chip_smoke.py times as each kernel's
    library_ms compute the kernel's function (here on the CPU)."""
    import chip_smoke
    x, w, b = _conv_inputs(rng, 97, 15, 6, 10)
    xt, wt, bt = map(torch.from_numpy, (x, w, b))
    with precision_scope(None):
        lib = chip_smoke.conv_library(xt, wt.permute(2, 1, 0).contiguous(), bt)
    np.testing.assert_allclose(lib.transpose(1, 2).numpy(),
                               conv1d_fused.conv1d_lrelu_plain(xt, wt, bt),
                               atol=KERNEL_ATOL)
    u = torch.from_numpy(rng.standard_normal((2, 41, 5)).astype(np.float32))
    uw = torch.from_numpy(rng.standard_normal(5).astype(np.float32))
    got = chip_smoke.interp_library(
        u, chip_smoke.interp_library_weights(uw), context).transpose(1, 2)
    want = interp.learned_interp_plain(u, uw, context)
    assert got.shape == want.shape == (2, 81 if context else 82, 5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=KERNEL_ATOL)
