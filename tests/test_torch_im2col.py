"""The channel-major im2col conv module against the JAX package, on the CPU.

``conv1d_lrelu_im2col_plain`` is held against the Pallas kernel it replaces
(``waveunet_tpu/ops/pallas/conv1d_im2col.py``), run in interpret mode as
tests/test_pallas.py runs it, on the same numpy inputs; against the
channel-last plain version on the transposed data; and on a decimated view.
Tolerance 1e-5: both sides compute in fp32, and only the order of the sums
differs. The CUDA kernel itself is held against the plain version on the
card by chip_smoke.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from waveunet_tpu.ops.pallas.conv1d_im2col import (
    conv1d_lrelu_im2col as jax_im2col)

import chip_smoke
from waveunet_tpu_torch.config import get_config
from waveunet_tpu_torch.ops import shapes
from waveunet_tpu_torch.ops.conv import precision_scope
from waveunet_tpu_torch.ops.kernels import conv1d_fused, conv1d_im2col

KERNEL_ATOL = 1e-5


def _inputs(rng, B, cin, L, K, cout):
    x = rng.standard_normal((B, cin, L)).astype(np.float32)
    lim = np.sqrt(6.0 / (K * (cin + cout)))
    w = rng.uniform(-lim, lim, (K, cin, cout)).astype(np.float32)
    b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("K", [15, 5])
@pytest.mark.parametrize("cin", [2, 24])
def test_im2col_plain_matches_pallas(rng, K, cin):
    # L_out = 700 - K + 1 (686, 696) is no multiple of the Pallas tile (512)
    x, w, b = _inputs(rng, 2, cin, 700, K, 24)
    want = jax_im2col(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                      interpret=True)
    got = conv1d_im2col.conv1d_lrelu_im2col_plain(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    assert got.shape == want.shape == (2, 24, 700 - K + 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=KERNEL_ATOL)


def test_im2col_plain_reads_a_decimated_view(rng):
    """The time-strided view x[:, :, ::2] gives what its contiguous copy
    gives (the kernel reads such a view without a copy)."""
    x, w, b = _inputs(rng, 2, 6, 129, 15, 12)
    xt, wt, bt = map(torch.from_numpy, (x, w, b))
    view = xt[:, :, ::2]
    assert not view.is_contiguous()
    got = conv1d_im2col.conv1d_lrelu_im2col_plain(view, wt, bt)
    want = conv1d_im2col.conv1d_lrelu_im2col_plain(view.contiguous(), wt, bt)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("K,cin,cout", [(15, 2, 24), (5, 40, 17)])
def test_im2col_plain_matches_channel_last_plain(rng, K, cin, cout):
    x, w, b = _inputs(rng, 2, cin, 301, K, cout)
    xt, wt, bt = map(torch.from_numpy, (x, w, b))
    got = conv1d_im2col.conv1d_lrelu_im2col_plain(xt, wt, bt)
    want = conv1d_fused.conv1d_lrelu_plain(xt.transpose(1, 2), wt, bt)
    np.testing.assert_allclose(got.numpy(), want.transpose(1, 2).numpy(),
                               atol=KERNEL_ATOL)


def test_im2col_wrapper_takes_plain_version_on_cpu_without_launching(rng):
    x, w, b = _inputs(rng, 2, 8, 64, 5, 16)
    xt, wt, bt = map(torch.from_numpy, (x, w, b))
    before = conv1d_im2col.launches
    y = conv1d_im2col.conv1d_lrelu_im2col(xt, wt, bt)
    torch.testing.assert_close(
        y, conv1d_im2col.conv1d_lrelu_im2col_plain(xt, wt, bt), rtol=0,
        atol=0)
    assert conv1d_im2col.launches == before


def test_im2col_wrapper_refuses_other_devices():
    x = torch.zeros(1, 2, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        conv1d_im2col.conv1d_lrelu_im2col(
            x, torch.zeros(3, 2, 4, device="meta"),
            torch.zeros(4, device="meta"))


def test_im2col_plain_refuses_input_shorter_than_filter():
    with pytest.raises(ValueError, match="shorter than filter"):
        conv1d_im2col.conv1d_lrelu_im2col_plain(
            torch.zeros(1, 2, 4), torch.zeros(5, 2, 3), torch.zeros(3))


def test_chip_smoke_ncl_library_yardstick_matches_plain_version(rng):
    """The single PyTorch call chip_smoke.py times as the im2col kernel's
    library_ms (cuDNN on the channel-major tensor) computes its function
    (here on the CPU), on a decimated view as the model's layers give it."""
    x, w, b = _inputs(rng, 2, 6, 195, 15, 10)
    xt, wt, bt = map(torch.from_numpy, (x, w, b))
    view = xt[:, :, ::2]
    with precision_scope(None):
        lib = chip_smoke.conv_library_ncl(
            view, wt.permute(2, 1, 0).contiguous(), bt)
    want = conv1d_im2col.conv1d_lrelu_im2col_plain(view, wt, bt)
    assert lib.shape == want.shape == (2, 10, 98 - 15 + 1)
    np.testing.assert_allclose(lib.numpy(), want.numpy(), atol=KERNEL_ATOL)


@pytest.mark.parametrize("decimated", [False, True])
def test_chip_smoke_channel_major_copy(rng, decimated):
    """chip_smoke.py runs the im2col kernel on a channel-major copy of each
    conv input of the forward; a decimated view stays a ::2 view of an
    undecimated copy."""
    full = torch.from_numpy(rng.standard_normal((2, 9, 5)).astype(np.float32))
    x = full[:, ::2, :] if decimated else full
    cm = chip_smoke.channel_major(x)
    torch.testing.assert_close(cm, x.transpose(1, 2), rtol=0, atol=0)
    assert cm.stride(2) == (2 if decimated else 1)


def test_chip_smoke_im2col_tool_shapes_follow_the_tool():
    """The 12 down-path shapes of tools/pallas_im2col_bench.py: full_44KHz at
    its training window, Cin 2 -> 264, Cout 24 -> 288, K 15."""
    cfg = get_config("full_44KHz")
    in_len, _ = shapes.get_padding(cfg, cfg.num_frames)
    rows = chip_smoke.im2col_tool_shapes(cfg, in_len)
    assert [r[1] for r in rows] == [147443, 73715, 36851, 18419, 9203, 4595,
                                    2291, 1139, 563, 275, 131, 59]
    assert [r[3] for r in rows] == [2] + [24 * i for i in range(1, 12)]
    assert [r[4] for r in rows] == [24 * i for i in range(1, 13)]
    assert {r[2] for r in rows} == {15}
    bounds = [chip_smoke.conv_bound(16 * cin * L, K, cin, cout,
                                    16 * (L - K + 1) * cout)
              for _, L, K, cin, cout in rows]
    # 3xTF32 on the tensor cores, and the CUDA-core fp32 bound beside it
    assert sum(b[0] for b in bounds) == pytest.approx(2.0018, abs=1e-3)
    assert sum(b[2] for b in bounds) == pytest.approx(4.8227, abs=1e-3)
