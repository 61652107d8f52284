"""The port's device resampler against the JAX package's, on the CPU.

``resample_device`` (``waveunet_tpu_torch/ops/resample.py``) computes the
host path's polyphase sums with one stride-q convolution a phase; it is
held against ``resample_jnp`` and the host ``resample`` at the 2e-3 of
``tests/test_resample.py:45-74``, on 22050 -> 44100 and on the four pairs
whose plan prepends zeros (c > 0). On the card ``chip_smoke.py`` phase
``resample`` holds it against the host at full song length.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from waveunet_tpu.ops.resample import _resample_plan as jax_plan
from waveunet_tpu.ops.resample import resample as jax_resample
from waveunet_tpu.ops.resample import resample_jnp
from waveunet_tpu_torch.ops.resample import (_resample_plan, resample,
                                             resample_device)
from torch_cpu import few_threads  # noqa: F401

ATOL = 2e-3  # fp32 device sums against the fp64 host (test_resample.py:53)
PAIRS = [(22050, 44100), (48000, 44100), (44100, 8192), (8192, 44100),
         (2, 3)]


@pytest.mark.parametrize("orig,new", PAIRS)
def test_device_matches_jax_and_host(orig, new):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4096, 2)).astype(np.float32)
    if (orig, new) != (22050, 44100):
        assert _resample_plan(4096, orig, new)[4] > 0  # c > 0 covered
    got = resample_device(x, orig, new, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    got = got.numpy()
    want_jax = np.asarray(resample_jnp(jnp.asarray(x), orig, new))
    want_host = resample(x, orig, new)
    assert got.shape == want_jax.shape == want_host.shape
    np.testing.assert_allclose(got, want_jax, atol=ATOL)
    np.testing.assert_allclose(got, want_host, atol=ATOL)
    np.testing.assert_allclose(want_host, jax_resample(x, orig, new),
                               atol=1e-6)


@pytest.mark.parametrize("orig,new", PAIRS)
def test_plan_is_the_jax_packages(orig, new):
    for n in (1, 4096, 44100):
        mine, theirs = _resample_plan(n, orig, new), jax_plan(n, orig, new)
        np.testing.assert_array_equal(mine[2], theirs[2])
        assert mine[:2] + mine[3:] == theirs[:2] + theirs[3:]


def test_mono_tensor_input_and_identity():
    x = torch.from_numpy(np.sin(np.arange(2205) / 7.0).astype(np.float32))
    y = resample_device(x, 22050, 44100)
    assert y.shape == (4410,)
    np.testing.assert_allclose(y.numpy(), resample(x.numpy(), 22050, 44100),
                               atol=ATOL)
    assert torch.equal(resample_device(x, 22050, 22050), x)


def test_short_input_covers_every_phase():
    """Fewer outputs than phases (p = 147): each output still comes from
    its own phase."""
    x = np.linspace(-1, 1, 9, dtype=np.float32)[:, None]
    got = resample_device(x, 48000, 44100, device="cpu").numpy()
    np.testing.assert_allclose(got, resample(x, 48000, 44100), atol=ATOL)


def test_nonpositive_rates_raise():
    a = np.zeros((10, 1), np.float32)
    for orig, new in [(0, 8000), (8000, 0), (-1, 8000), (8000, -5)]:
        with pytest.raises(ValueError, match="positive"):
            resample_device(a, orig, new, device="cpu")
