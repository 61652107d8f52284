"""The port's spectrogram family against the JAX package and TF goldens, on
the CPU.

STFT/iSTFT against tests/golden/stft_tf.npz and the JAX functions; conv2d,
conv2d_transpose and eval batch norm against tests/golden/spectro_ops_tf.npz;
the shrunken U7 forward and its Separator against the JAX package's at 5e-5
(tests/test_compat.py:99), with the same parameters and BN statistics.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from waveunet_tpu.config import get_config as jax_get_config
from waveunet_tpu.infer.engine import Separator as JaxSeparator
from waveunet_tpu.models.spectrogram_unet import (
    apply_spectrogram_unet as jax_apply, init_spectrogram_unet as jax_init)
from waveunet_tpu.ops import primitives as jax_primitives
from waveunet_tpu.ops import stft as jax_stft

from waveunet_tpu_torch.compat.params import params_from_numpy
from waveunet_tpu_torch.config import get_config
from waveunet_tpu_torch.infer.engine import Separator, separate_file
from waveunet_tpu_torch.models import spectrogram_unet as su
from waveunet_tpu_torch.ops import stft as S
from waveunet_tpu_torch.ops.conv import conv2d, conv2d_transpose
from waveunet_tpu_torch.ops.primitives import pad_freqs
from torch_cpu import few_threads  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
SMALL = dict(num_layers=3, num_frames=768 * 15 + 1024, num_initial_filters=4)
ATOL = 5e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")


@pytest.fixture(scope="module")
def model():
    """JAX-initialised U7 params with perturbed biases and BN statistics,
    so that every parameter kind reaches the output."""
    jcfg = jax_get_config("unet_spectrogram", **SMALL)
    p, st = jax_init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)

    def noise(a, scale):
        return np.asarray(a) + scale * rng.standard_normal(a.shape).astype(
            np.float32)

    p = jax.tree_util.tree_map(lambda a: noise(a, 0.05), p)
    st = jax.tree_util.tree_map(lambda a: np.abs(noise(a, 0.1)), st)
    return jcfg, get_config("unet_spectrogram", **SMALL), p, st


def test_stft_istft_match_tf_golden():
    z = np.load(os.path.join(GOLDEN, "stft_tf.npz"))
    spec = S.stft(_t(z["x"]))
    assert spec.dtype == torch.complex64
    np.testing.assert_allclose(spec.numpy(), z["spec"], atol=2e-3)
    np.testing.assert_allclose(S.istft(_t(z["spec"])).numpy(), z["audio"],
                               atol=2e-4)


def test_stft_istft_match_jax():
    x = np.random.default_rng(1).standard_normal((3, 768 * 9 + 1024 + 77)
                                                 ).astype(np.float32)
    spec = S.stft(_t(x)).numpy()
    want = np.asarray(jax_stft.stft(jnp.asarray(x)))
    assert spec.shape == want.shape == (3, 10, 513)
    np.testing.assert_allclose(spec, want, atol=2e-5)
    np.testing.assert_allclose(S.istft(_t(want)).numpy(),
                               np.asarray(jax_stft.istft(jnp.asarray(want))),
                               atol=2e-6)


@pytest.mark.parametrize("n", [0, 1023, 1024, 1791, 1792, 768 * 15 + 1024])
def test_framing_matches_jax(n):
    assert S.num_frames(n) == jax_stft.num_frames(n)
    x = np.arange(2 * n, dtype=np.float32).reshape(2, n)
    np.testing.assert_array_equal(S.frame_signal(_t(x)).numpy(),
                                  np.asarray(jax_stft.frame_signal(
                                      jnp.asarray(x))))


def test_windows_match_jax():
    np.testing.assert_array_equal(S.hann_periodic(1024).numpy(),
                                  np.asarray(jax_stft.hann_periodic(1024)))
    np.testing.assert_array_equal(
        S.synthesis_window().numpy(),
        jax_stft._synthesis_window(1024, 768).astype(np.float32))


def test_griffin_lim_matches_jax():
    sr = 8192
    t = np.arange(768 * 10 + 1024) / sr
    x = (0.5 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
    mag = np.abs(np.asarray(jax_stft.stft(jnp.asarray(x[None]))))[0]
    phase = np.random.default_rng(3).uniform(-np.pi, np.pi, mag.shape)
    got = S.griffin_lim(mag, iterations=6, init_phase=phase, length=len(x),
                        device="cpu")
    want = jax_stft.griffin_lim(mag, iterations=6, init_phase=phase,
                                length=len(x))
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_conv2d_ops_and_batch_norm_match_tf_golden():
    z = np.load(os.path.join(GOLDEN, "spectro_ops_tf.npz"))
    x = _t(z["x"])
    y = conv2d(x, {"kernel": _t(z["k"]), "bias": _t(z["b"])}, stride=(2, 2))
    np.testing.assert_allclose(y.numpy(), z["y_conv"], atol=2e-5)
    y = conv2d_transpose(x, {"kernel": _t(z["kt"]), "bias": _t(z["bt"])},
                         stride=(2, 2))
    assert tuple(y.shape) == z["y_tr"].shape
    np.testing.assert_allclose(y.numpy(), z["y_tr"], atol=2e-5)
    y = su._bn(x, _t(z["beta"]), {"mean": _t(z["mean"]), "var": _t(z["var"])})
    np.testing.assert_allclose(y.numpy(), z["y_bn"], atol=2e-5)


@pytest.mark.parametrize("shape,target,axis,value", [
    ((1, 4, 6, 1), 9, 2, 0.5), ((2, 5, 3), 8, 1, 0.0), ((1, 4, 6, 1), 6, 2,
                                                        0.5)])
def test_pad_freqs_matches_jax(shape, target, axis, value):
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    np.testing.assert_array_equal(
        pad_freqs(_t(x), target, axis=axis, value=value).numpy(),
        np.asarray(jax_primitives.pad_freqs(jnp.asarray(x), target, axis=axis,
                                            value=value)))
    with pytest.raises(ValueError):
        pad_freqs(_t(x), shape[axis] - 1, axis=axis)


def test_init_matches_jax_shapes():
    jcfg = jax_get_config("unet_spectrogram", **SMALL)
    jp, js = jax_init(jax.random.PRNGKey(0), jcfg)
    p, st = su.init_spectrogram_unet(torch.Generator().manual_seed(0),
                                     get_config("unet_spectrogram", **SMALL),
                                     "cpu")
    for got, want in ((p, jp), (st, js)):
        assert list(got) == list(want)
        for k in want:
            assert {n: tuple(t.shape) for n, t in got[k].items()} == {
                n: tuple(a.shape) for n, a in want[k].items()}, k
    assert (st["vocals/down_0_bn"]["var"] == 1).all()


@pytest.mark.parametrize("spectrogram", [False, True])
def test_forward_matches_jax(model, spectrogram):
    jcfg, cfg, p, st = model
    mix = (0.3 * np.random.default_rng(4).standard_normal(
        (2, cfg.num_frames, 1))).astype(np.float32)
    want, _ = jax_apply(jax.tree_util.tree_map(jnp.asarray, p), jcfg,
                        jnp.asarray(mix), training=False,
                        state=jax.tree_util.tree_map(jnp.asarray, st),
                        return_spectrogram=spectrogram)
    got, state = su.apply_spectrogram_unet(_tree(p), cfg, _t(mix),
                                           state=_tree(st),
                                           return_spectrogram=spectrogram)
    assert sorted(state) == sorted(st)
    for s in cfg.source_names:
        assert got[s].shape == want[s].shape
        np.testing.assert_allclose(got[s].numpy(), np.asarray(want[s]),
                                   atol=ATOL, err_msg=s)


@pytest.mark.parametrize("wire", ["float32", "int16"])
def test_separator_matches_jax(model, wire):
    jcfg, cfg, p, st = model
    jcfg = jcfg.replace(infer_batch=2, infer_wire_dtype=wire)
    cfg = cfg.replace(infer_batch=2, infer_wire_dtype=wire)
    jsep = JaxSeparator(jcfg, jax.tree_util.tree_map(jnp.asarray, p),
                        model_state=jax.tree_util.tree_map(jnp.asarray, st))
    sep = Separator(cfg, _tree(p), model_state=_tree(st), device="cpu")
    assert (sep.in_len, sep.out_len) == (jsep.in_len, jsep.out_len)
    rng = np.random.default_rng(5)
    for n in (sep.out_len * 2 + 917, sep.out_len // 3):  # 3 windows; short
        audio = (0.2 * rng.standard_normal((n, 2))).astype(np.float32)
        got = sep.separate(audio, 8192)
        want = jsep.separate(audio, 8192)
        atol = ATOL if wire == "float32" else 1 / 32767 + ATOL
        for s in cfg.source_names:
            assert got[s].shape == want[s].shape == (n, 1)
            np.testing.assert_allclose(got[s], want[s], atol=atol, err_msg=s)


def test_separate_file_carries_model_state(model, tmp_path):
    from waveunet_tpu_torch.data.audio_io import load_wav, write_wav

    _, cfg, p, st = model
    n = cfg.num_frames + 777
    audio = (0.2 * np.sin(2 * np.pi * 220 * np.arange(n) / 8192)
             ).astype(np.float32)[:, None]
    src = str(tmp_path / "in.wav")
    write_wav(src, audio, 8192)
    written = separate_file(cfg, _tree(p), src, output_path=str(tmp_path),
                            device="cpu", model_state=_tree(st))
    assert set(written) == set(cfg.source_names)
    for path in written.values():
        est, sr = load_wav(path)
        assert sr == 8192 and est.shape == (n, 1) and np.isfinite(est).all()


def test_inference_only_and_mono_only():
    cfg = get_config("unet_spectrogram", **SMALL)
    params, state = su.init_spectrogram_unet(torch.Generator().manual_seed(0),
                                             cfg, "cpu")
    mix = torch.zeros(1, cfg.num_frames, 1)
    # inference builds no autograd graph and leaves the statistics alone;
    # training (tests/test_torch_train_step.py) is differentiable
    for leaves in params.values():
        for t in leaves.values():
            t.requires_grad_(True)
    out, st = su.apply_spectrogram_unet(params, cfg, mix, state=state)
    assert st is state and all(v.grad_fn is None for v in out.values())
    out, st = su.apply_spectrogram_unet(params, cfg, mix, training=True,
                                        state=state)
    assert st is not state and all(v.grad_fn is not None
                                   for v in out.values())
    # bf16 compute is inference's alone, and no more differentiable
    # (tests/test_torch_spectrogram_bf16.py holds it against the JAX package)
    out, st = su.apply_spectrogram_unet(params, cfg.replace(
        compute_dtype="bfloat16"), mix, state=state)
    assert st is state and all(v.grad_fn is None and torch.isfinite(v).all()
                               for v in out.values())
    with pytest.raises(NotImplementedError):
        su.init_spectrogram_unet(torch.Generator(), get_config(
            "unet_spectrogram", mono_downmix=False), "cpu")
    with pytest.raises(ValueError, match="mono"):
        su.apply_spectrogram_unet(params, cfg, torch.zeros(1, 100, 2),
                                  state=state)


def test_framing_slack_is_rejected():
    """A forward whose iSTFT length is not the stitch hop raises instead of
    stitching silence into the song."""
    from waveunet_tpu_torch.infer.engine import model_forward
    from waveunet_tpu_torch.ops import shapes

    cfg = get_config("unet_spectrogram", num_layers=3)
    with pytest.raises(ValueError, match="framing slack"):
        shapes.get_padding(cfg, 768 * 15 + 1024 + 500)
    cfg = get_config("unet_spectrogram", **SMALL)
    params, state = su.init_spectrogram_unet(torch.Generator().manual_seed(0),
                                             cfg, "cpu")
    fwd = model_forward(cfg, state, cfg.num_frames + 768)
    with pytest.raises(ValueError, match="framing slack"):
        fwd(params, torch.zeros(1, cfg.num_frames, 1))
