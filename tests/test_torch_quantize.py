"""The port's int16 wire against the JAX package's, on the CPU.

Host to device: ``waveunet_tpu_torch.infer.wire.quantize_int16`` must equal
the JAX package's native host quantiser (``runtime/host_ops.cc``, float32
throughout, half away from zero) bit for bit; it is skipped only where that
library cannot build. ``np.round`` (half to even) differs, which pins the
repair. Device to host: ``to_wire`` rounds half to even like ``jnp.round``
in the JAX engine and carries NaN/Inf as INT16_MIN.
"""

import numpy as np
import pytest
import torch

from waveunet_tpu.runtime import native

from waveunet_tpu_torch.infer.wire import (INT16_NONFINITE, from_wire,
                                           from_wire_np, quantize_int16,
                                           to_wire)


@pytest.fixture(scope="module")
def native_quantize():
    if not native.available():
        pytest.skip("the JAX package's native host library did not build")
    return native.quantize_int16


def _ties():
    n = np.arange(-32768, 32768, dtype=np.float64)
    return ((n + 0.5) / 32767).astype(np.float32)


def _inputs(name):
    if name == "random_stereo":
        rng = np.random.default_rng(0)
        return (0.3 * rng.standard_normal((1 << 20, 2))).astype(np.float32)
    if name == "exact_ties":
        return _ties()
    if name == "near_ties":
        t = _ties()
        up = np.nextafter(t, np.float32(2))
        down = np.nextafter(t, np.float32(-2))
        named = np.array([0.5 / 32767, 0.49999997 / 32767, -0.5 / 32767,
                          -0.49999997 / 32767], np.float32)
        return np.concatenate([up, down, np.nextafter(down, np.float32(-2)),
                               named])
    if name == "beyond_unit":
        return np.array([1.0, -1.0, 1.0000001, -1.0000001, 1.5, -3.0, 1e30,
                         -1e30, np.inf, -np.inf, 0.99999994, -0.99999994],
                        np.float32)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["random_stereo", "exact_ties", "near_ties",
                                  "beyond_unit"])
def test_host_quantiser_matches_native_bit_for_bit(native_quantize, name):
    x = _inputs(name)
    got = quantize_int16(x)
    assert got.dtype == np.int16 and got.shape == x.shape
    np.testing.assert_array_equal(got, native_quantize(x))


def test_round_half_to_even_differs(native_quantize):
    """np.round, the port's earlier quantiser, gives another int16 song."""
    x = _inputs("random_stereo")
    rounded = np.round(np.clip(x, -1.0, 1.0) * 32767.0).astype(np.int16)
    assert (rounded != native_quantize(x)).sum() > 100
    tie = np.array([0.5 / 32767, 0.49999997 / 32767], np.float32)
    np.testing.assert_array_equal(quantize_int16(tie), [1, 1])
    np.testing.assert_array_equal(
        np.round(tie.astype(np.float64) * 32767.0), [0.0, 0.0])


def test_device_quantiser_rounds_half_to_even_with_a_sentinel():
    v = torch.tensor([0.5 / 32767, 1.5 / 32767, -0.5 / 32767, 2.0, -2.0,
                      float("nan"), float("inf"), -float("inf")])
    want = [0, 2, 0, 32767, -32767] + [INT16_NONFINITE] * 3
    w = to_wire(v)
    assert w.dtype == torch.int16
    assert w.tolist() == want
    back = from_wire(w)
    assert torch.isnan(back[5:]).all() and back[3] == 1.0
    np.testing.assert_array_equal(from_wire_np(w.numpy()), back.numpy())


def test_dequantisers_divide_like_the_jax_package():
    """Every int16 value back to float32 is the float32 quotient x / 32767
    (the JAX package's ``x / 32767.0``): ``dequantize`` divides by a 0-d
    tensor on the operand's device, which a CUDA tensor does not turn into
    a multiplication by the reciprocal, and ``from_wire`` adds the NaN
    sentinel; ``from_wire_np`` agrees."""
    from waveunet_tpu_torch.infer.wire import dequantize, full_scale

    w = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    want = w.numpy().astype(np.float32) / np.float32(32767.0)
    np.testing.assert_array_equal(dequantize(w).numpy(), want)
    want[0] = np.nan  # INT16_NONFINITE
    np.testing.assert_array_equal(from_wire(w).numpy(), want)
    np.testing.assert_array_equal(from_wire_np(w.numpy()), want)
    cpu = torch.device("cpu")
    assert full_scale(cpu) is full_scale(cpu) and full_scale(cpu).ndim == 0
