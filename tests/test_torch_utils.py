"""The port's ``Utils`` names against the JAX package's, on the CPU.

``waveunet_tpu_torch.utils`` has every public name of
``waveunet_tpu/utils.py``, and the cases of
``tests/test_ops.py::test_utils_migration_shim`` and
``tests/test_stft.py::test_shim_accepts_reference_orientation`` give the
JAX package's results.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveunet_tpu import utils as jax_utils
from waveunet_tpu.models.waveunet import init_waveunet as jax_init
from waveunet_tpu.ops import stft as jax_stft
from waveunet_tpu_torch import utils
from waveunet_tpu_torch.data.audio_io import write_wav
from waveunet_tpu_torch.config import get_config
from waveunet_tpu_torch.models.waveunet import init_waveunet


def _public(module):
    return {n for n in dir(module) if not n.startswith("_")
            and not isinstance(getattr(module, n), type(np))}


def test_every_public_name_is_there():
    missing = _public(jax_utils) - _public(utils)
    assert not missing, missing


def test_migration_shim_cases_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 10, 2)).astype(np.float32)
    t, j = torch.from_numpy(x), jnp.asarray(x)
    for shape in ([1, 6, 2], 6):
        np.testing.assert_array_equal(utils.crop(t, shape).numpy(),
                                      np.asarray(jax_utils.crop(j, shape)))
    np.testing.assert_array_equal(utils.LeakyReLU(t).numpy(),
                                  np.asarray(jax_utils.LeakyReLU(j)))
    np.testing.assert_array_equal(
        utils.AudioClip(torch.tensor([2.0, -3.0]), training=False).numpy(),
        [1.0, -1.0])
    skip = rng.standard_normal((1, 12, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        utils.crop_and_concat(torch.from_numpy(skip), t).numpy(),
        np.asarray(jax_utils.crop_and_concat(jnp.asarray(skip), j)))
    np.testing.assert_array_equal(
        utils.pad_freqs(t, 13).numpy(),
        np.asarray(jax_utils.pad_freqs(j, 13)))
    r = utils.resample(np.ones(1000, np.float32), 22050, 44100)
    assert r.shape[0] == 2000
    np.testing.assert_allclose(
        r, jax_utils.resample(np.ones(1000, np.float32), 22050, 44100),
        rtol=0, atol=1e-6)


def test_load_and_get_num_params(tmp_path):
    path = str(tmp_path / "x.wav")
    write_wav(path, np.linspace(-0.5, 0.5, 2000, dtype=np.float32)
              .reshape(1000, 2), 8000)
    for kw in (dict(), dict(mono=False), dict(sr=16000)):
        got, sr = utils.load(path, **kw)
        want, want_sr = jax_utils.load(path, **kw)
        assert sr == want_sr and got.shape == want.shape
        # the JAX package may resample with its native kernel (the same
        # taps; float32 rounding apart)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    cfg = get_config("baseline", num_layers=2, num_initial_filters=4)
    params = init_waveunet(torch.Generator().manual_seed(0), cfg, "cpu")
    assert utils.getNumParams(params) == jax_utils.getNumParams(
        jax_init(jax.random.PRNGKey(0), cfg))


def _spectrum():
    sr = 8192
    t = np.arange(768 * 6 + 1024) / sr
    x = 0.4 * np.sin(2 * np.pi * 330.0 * t).astype(np.float32)
    spec = np.asarray(jax_stft.stft(jnp.asarray(x[None])))[0]
    return np.abs(spec), np.angle(spec)


def test_shim_accepts_reference_orientation():
    mag, phase = _spectrum()
    want = jax_utils.spectrogramToAudioFile(mag, phaseIterations=0,
                                            phase=phase)
    ours = utils.spectrogramToAudioFile(mag, phaseIterations=0, phase=phase,
                                        device="cpu")
    ref_orient = utils.spectrogramToAudioFile(mag.T, phaseIterations=0,
                                              phase=phase.T, device="cpu")
    np.testing.assert_allclose(ours, want, atol=1e-6)
    np.testing.assert_allclose(ref_orient, ours, atol=1e-6)
    cut = utils.spectrogramToAudioFile(mag, phaseIterations=0, phase=phase,
                                       length=1000, device="cpu")
    np.testing.assert_array_equal(cut, ours[:1000])
    with pytest.raises(ValueError, match="frequency bins"):
        utils.spectrogramToAudioFile(mag[:, :-1], device="cpu")


def test_griffin_lim_path_and_square_warning():
    mag, phase = _spectrum()
    want = jax_utils.spectrogramToAudioFile(mag, phaseIterations=3,
                                            phase=phase)
    got = utils.spectrogramToAudioFile(mag, phaseIterations=3, phase=phase,
                                       device="cpu")
    np.testing.assert_allclose(got, want, atol=1e-5)
    square = np.ones((513, 513), np.float32)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        utils.spectrogramToAudioFile(square, phaseIterations=0,
                                     phase=np.zeros_like(square),
                                     device="cpu")
    assert any("ambiguous" in str(x.message) for x in w)
