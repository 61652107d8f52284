"""The port's device resampler against the JAX package's, on the CPU.

``resample_device`` (``waveunet_tpu_torch/ops/resample.py``) computes the
host path's polyphase sums in float64, with one stride-q convolution a
phase on the CPU (``resample_polyphase``) and the kernel
``ops/kernels/csrc/resample_poly.cu`` on the card. On the CPU it is held
against ``resample_jnp`` and the host ``resample`` at the 2e-3 of
``tests/test_resample.py:45-74``, and against the host within one fp32 ulp
(both round a float64 sum of the same terms once), on 22050 -> 44100 and
on the four pairs whose plan prepends zeros (c > 0); the kernel's
indexing is emulated here against the host, from fp32 and float64 audio,
and ``Separator.separate``'s choice of the card's route (a CUDA device
and another rate) is checked without a card. On the card
``chip_smoke.py`` phase ``resample`` holds the kernel against the host at
full song length, within one fp32 ulp.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from waveunet_tpu.ops.resample import _resample_plan as jax_plan
from waveunet_tpu.ops.resample import resample as jax_resample
from waveunet_tpu.ops.resample import resample_jnp
from waveunet_tpu_torch import tracing
from waveunet_tpu_torch.compat.params import params_from_numpy
from waveunet_tpu_torch.config import get_config
from waveunet_tpu_torch.infer.engine import Separator
from waveunet_tpu_torch.ops.kernels import resample_poly
from waveunet_tpu_torch.ops.resample import (_resample_plan, polyphase_bank,
                                             resample, resample_device)
from test_torch_model import numpy_params
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


def _song(n, mono, seed=11, dtype=np.float32):
    x = np.random.default_rng(seed).standard_normal((n, 2))
    return (x[:, 0] if mono else x).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("mono", [False, True], ids=["stereo", "mono"])
@pytest.mark.parametrize("orig,new", PAIRS)
def test_device_sums_in_float64_within_one_ulp_of_host(orig, new, mono,
                                                       dtype):
    """The plain version sums the host's terms in float64 in another order
    and rounds once: within one fp32 ulp of the host, far inside 2e-3; a
    float64 song is read as it is, as the host reads it."""
    x = _song(4096, mono, dtype=dtype)
    got = resample_device(torch.from_numpy(x), orig, new)
    assert got.dtype == torch.float32 and got.shape == (
        _resample_plan(4096, orig, new)[6],) + x.shape[1:]
    np.testing.assert_array_max_ulp(got.numpy(), resample(x, orig, new),
                                    maxulp=1)


def _emulate_kernel(x, orig, new):
    """``csrc/resample_poly.cu``'s arithmetic, every thread at once: thread
    ``idx`` takes phase r = idx // T and output j = r + p*t, sums
    bank[phi][i] * x[lo + i] over i in [i0, i1) in order, rounds once."""
    n, C = x.shape
    p, q, _, _, c, start, n_out = _resample_plan(n, orig, new)
    bank, L = polyphase_bank(p, q)
    assert (L - 1) // p + 1 == bank.shape[1]  # the launcher's kmax check
    T = -(-n_out // p)
    idx = np.arange(min(p, n_out) * T, dtype=np.int64)
    r, t = idx // T, idx % T
    j = r + p * t
    keep = j < n_out
    r, t, j = r[keep], t[keep], j[keep]
    u = (start + r) * q
    phi, base = u % p, u // p + q * t
    K = (L - 1 - phi) // p + 1
    lo = base - (K - 1) - c
    i0 = np.where(lo < 0, np.minimum(-lo, K), 0)
    i1 = np.where(n - lo < K, np.maximum(n - lo, i0), K)
    acc = np.zeros((len(j), C))
    for i in range(bank.shape[1]):
        on = (i >= i0) & (i < i1)
        acc += np.where(on, bank[phi, i], 0.0)[:, None] * x[
            np.clip(lo + i, 0, n - 1)].astype(np.float64)
    y = np.full((n_out, C), np.nan, np.float32)
    y[j] = acc.astype(np.float32)
    return y


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("orig,new,n", [
    (44100, 22050, 1000), (22050, 44100, 300), (48000, 44100, 9),
    (48000, 44100, 700), (44100, 8192, 3000), (8192, 44100, 60),
    (2, 3, 50)])
def test_kernel_indexing_matches_host(orig, new, n, dtype):
    """Every output written once, each from the host's terms (the c
    prepended zeros and the tail zeros as index bounds): within one fp32
    ulp of the host, on a song shorter than the filter too, from fp32 and
    from float64 audio (the kernel's two input types)."""
    x = _song(n, False, dtype=dtype)
    got = _emulate_kernel(x, orig, new)
    assert not np.isnan(got).any()
    np.testing.assert_array_max_ulp(got, resample(x, orig, new), maxulp=1)


@pytest.mark.parametrize("cuda", [True, False], ids=["cuda", "cpu"])
@pytest.mark.parametrize("sr", [22050, 44100], ids=["other-rate", "model-rate"])
def test_separate_resamples_on_card_only_for_cuda_and_other_rate(cuda, sr):
    cfg = get_config("full_44KHz", num_layers=2, num_initial_filters=4,
                     infer_num_frames=256, infer_batch=4)
    sep = Separator(cfg, params_from_numpy(numpy_params(cfg), "cpu"),
                    device="cpu")
    if cuda:  # the device check alone, stubbed
        sep.device = torch.device("cuda", 0)
    assert sep._resamples_on_card(sr) == (cuda and sr != 44100)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_separate_on_the_cpu_resamples_on_the_host(dtype):
    """On the CPU ``separate`` takes the host ``resample`` as before: its
    stems are bit for bit those of the song resampled first, and the card's
    counter stays at 0."""
    cfg = get_config("full_44KHz", num_layers=2, num_initial_filters=4,
                     infer_num_frames=256, infer_batch=4)
    sep = Separator(cfg, params_from_numpy(numpy_params(cfg), "cpu"),
                    device="cpu")
    mix = 0.4 * _song(3000, False, dtype=dtype)
    want = sep.separate(resample(mix, 22050, 44100), 44100)
    tracing.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        got = sep.separate(mix, 22050)
    rec = tracing.record()
    tracing.reset()
    assert rec["spans"]["resample"][0] == 1
    assert rec["counters"].get("separate.device_resample", 0) == 0
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])


def test_kernel_wrapper_refuses_host_tensors_and_grad():
    """The launch path never takes a CPU tensor, nor an input that
    requires grad (the kernel has no backward); off the card
    ``resample_device`` stays differentiable, its plain version plain
    PyTorch, and launches nothing."""
    x = torch.zeros(64, 2)
    with pytest.raises(ValueError, match="CUDA"):
        resample_poly.resample_poly_cuda(x, 44100, 22050)
    before = resample_poly.launches
    x = torch.from_numpy(_song(64, False)).requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        resample_poly.resample_poly_cuda(x, 44100, 22050)
    y = resample_device(x, 44100, 22050)
    assert y.shape == (32, 2) and y.requires_grad
    y.sum().backward()
    assert x.grad is not None and bool(x.grad.abs().sum() > 0)
    assert resample_poly.launches == before
