"""The port's engine beyond song mode, against the JAX package, on the CPU.

``resident_sweep`` (the bench's headline path) against the JAX package's and
against the port's own ``separate``; its chunk schedule and override; slab
mode against song mode; the batched sweep against a serial per-window loop
(the reference's semantics); the non-finite sentinel through a custom
``forward_fn``; the spectrogram family through the same engine hooks. The
CUDA graphs of ``precompile`` and of a graphed sweep need a card:
``chip_smoke.py`` checks them there, and here their CPU refusal is pinned.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from waveunet_tpu.config import get_config as jax_get_config
from waveunet_tpu.infer.engine import Separator as JaxSeparator
from waveunet_tpu.runtime import native

from waveunet_tpu_torch.compat.params import params_from_numpy
from waveunet_tpu_torch.config import get_config
from waveunet_tpu_torch.infer.engine import Separator, window_positions
from waveunet_tpu_torch.infer.wire import quantize_int16
from waveunet_tpu_torch.models.waveunet import apply_waveunet
from test_torch_model import numpy_params
from torch_cpu import few_threads  # noqa: F401

# the JAX package's own sweep tests: 3 layers, the 256-frame training
# window, batch 4, difference output (tests/test_infer.py:322)
SWEEP = dict(num_layers=3, num_frames=256, infer_batch=4,
             infer_num_frames=None, output_type="difference")


def _pair(preset="baseline", **kw):
    jcfg, cfg = jax_get_config(preset, **kw), get_config(preset, **kw)
    params = numpy_params(cfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    return (JaxSeparator(jcfg, jparams), jparams,
            Separator(cfg, params_from_numpy(params, "cpu"), device="cpu"))


def _audio(n, channels=1, seed=5):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((n, channels))).astype(np.float32)


def _padded(sep, audio):
    padded = np.pad(audio, [(sep.pad, sep.pad), (0, 0)])
    if sep.cfg.infer_wire_dtype == "int16":
        padded = quantize_int16(padded)
    return padded


@pytest.mark.parametrize("wire,n_win", [("float32", 13), ("int16", 13),
                                        ("float32", 3), ("int16", 3)])
def test_resident_sweep_matches_jax_and_separate(wire, n_win):
    jsep, jparams, sep = _pair(infer_wire_dtype=wire, **SWEEP)
    n = sep.out_len * (n_win - 1) + 31  # right-aligned last window
    audio = _audio(n)
    padded = _padded(sep, audio)
    fn, positions = sep.resident_sweep(n)
    assert positions.shape[0] == n_win
    out, checksum = fn(sep.params, torch.from_numpy(padded))
    assert np.isfinite(float(checksum))
    jfn, jpos = jsep.resident_sweep(n)
    np.testing.assert_array_equal(positions, jpos)
    jout, _ = jfn(jparams, jnp.asarray(padded))
    host = sep.separate(audio, sep.cfg.expected_sr)
    names = sep.cfg.source_names
    assert sorted(out) == sorted(names)
    for s in names:
        got = out[s].numpy()
        assert got.shape == (n, 1) and got.dtype == np.float32
        np.testing.assert_allclose(got, np.asarray(jout[s]), atol=2e-5,
                                   err_msg=f"vs JAX {s}")
        # int16 wire: the sweep rebuilds the difference source from the
        # quantised mix, separate() from the float mix: up to one step
        tol = 4e-5 if (wire == "int16" and s == names[-1]) else 2e-6
        np.testing.assert_allclose(got, host[s], atol=tol,
                                   err_msg=f"vs separate {s}")


@pytest.mark.parametrize("n_win", [1, 3, 4, 7, 11, 13, 41])
def test_resident_chunk_sizes_match_jax(n_win):
    jsep, _, sep = _pair(**SWEEP)
    assert sep.resident_chunk_sizes(n_win) == jsep.resident_chunk_sizes(n_win)


def test_resident_sweep_chunk_sizes_override():
    """Any covering schedule gives the production schedule's output (up to
    the order of the batch's sums); one that covers too few raises."""
    _, _, sep = _pair(**SWEEP)
    n = sep.out_len * 2 + 17  # 3 windows: the exact [3] chunk
    padded = torch.from_numpy(_padded(sep, _audio(n)))
    base, _ = sep.resident_sweep(n)[0](sep.params, padded)
    for sizes in ([2, 1], [4], [1, 1, 1]):
        out, _ = sep.resident_sweep(n, chunk_sizes=sizes)[0](sep.params,
                                                             padded)
        for s in sep.cfg.source_names:
            np.testing.assert_allclose(out[s].numpy(), base[s].numpy(),
                                       atol=1e-6, err_msg=f"{sizes} {s}")
    with pytest.raises(ValueError, match="cover"):
        sep.resident_sweep(n, chunk_sizes=[2])


def test_resident_sweep_too_short_raises():
    _, _, sep = _pair(**SWEEP)
    with pytest.raises(ValueError, match="shorter than one output window"):
        sep.resident_sweep(sep.out_len - 1)


@pytest.mark.parametrize("wire", ["float32", "int16"])
def test_slab_mode_matches_song_mode(wire):
    cfg = get_config("full_44KHz", num_layers=3, num_initial_filters=4,
                     infer_num_frames=256, infer_batch=4,
                     infer_wire_dtype=wire)
    params = params_from_numpy(numpy_params(cfg), "cpu")
    song = Separator(cfg, params, h2d_mode="song", device="cpu")
    slabs = Separator(cfg, params, h2d_mode="slabs", device="cpu")
    audio = _audio(song.out_len * 13 + 31, channels=2)
    a = song.separate(audio, 44100)
    b = slabs.separate(audio, 44100)
    for s in cfg.source_names:
        np.testing.assert_array_equal(b[s], a[s], err_msg=s)


def test_slab_mode_matches_jax_slab_mode():
    kw = dict(num_layers=3, num_initial_filters=4, infer_num_frames=256,
              infer_batch=4, infer_wire_dtype="int16")
    jcfg, cfg = jax_get_config("full_44KHz", **kw), get_config("full_44KHz",
                                                               **kw)
    params = numpy_params(cfg)
    jsep = JaxSeparator(jcfg, jax.tree_util.tree_map(jnp.asarray, params),
                        h2d_mode="slabs")
    sep = Separator(cfg, params_from_numpy(params, "cpu"), h2d_mode="slabs",
                    device="cpu")
    audio = _audio(sep.out_len * 9 + 7, channels=2)
    got, want = sep.separate(audio, 44100), jsep.separate(audio, 44100)
    for s in cfg.source_names:
        # one int16 step: a forward difference of 2e-5 may round across
        np.testing.assert_allclose(got[s], want[s], atol=1 / 32767 + 1e-7,
                                   err_msg=s)


def test_h2d_mode_is_checked():
    cfg = get_config("baseline", num_layers=3, num_frames=256)
    with pytest.raises(ValueError, match="h2d_mode"):
        Separator(cfg, params_from_numpy(numpy_params(cfg), "cpu"),
                  h2d_mode="pages", device="cpu")


@pytest.mark.parametrize("preset", ["baseline", "baseline_context"])
def test_batched_sweep_matches_serial_reference_loop(preset):
    """The batched engine against the reference's serial batch-1 loop over
    the padded song (tests/test_infer.py:40). Not byte for byte: the CPU's
    batched matmuls sum in another order than single windows' (2.2e-8
    measured), so 1e-6, tighter than the JAX package's 1e-5."""
    cfg = get_config(preset, num_layers=3, num_frames=256, infer_batch=4,
                     infer_num_frames=None)
    params = params_from_numpy(numpy_params(cfg), "cpu")
    sep = Separator(cfg, params, device="cpu")
    n = sep.out_len * 5 + 17
    audio = _audio(n)
    got = sep.separate(audio, cfg.expected_sr)
    padded = np.pad(audio, [(sep.pad, sep.pad), (0, 0)])
    want = {s: np.zeros_like(audio) for s in cfg.source_names}
    for p0 in range(0, n, sep.out_len):
        p0 = min(p0, n - sep.out_len)
        out = apply_waveunet(params, cfg, torch.from_numpy(
            padded[p0:p0 + sep.in_len][None]))
        for s in cfg.source_names:
            want[s][p0:p0 + sep.out_len] = out[s][0].numpy()
    for s in cfg.source_names:
        np.testing.assert_allclose(got[s], want[s], atol=1e-6, err_msg=s)


@pytest.mark.parametrize("wire", ["float32", "int16"])
def test_nonfinite_forward_reaches_the_host_as_nan(wire, tmp_path):
    """A custom forward_fn that diverges comes back as NaN on both wires,
    through separate() and through the resident sweep."""
    from waveunet_tpu_torch.data.audio_io import write_wav

    cfg = get_config("baseline", num_layers=3, num_frames=256, infer_batch=2,
                     infer_num_frames=None, infer_wire_dtype=wire)
    params = params_from_numpy(numpy_params(cfg), "cpu")
    calls = []

    def nan_forward(p, x):
        calls.append(x.shape[0])
        v = torch.full((x.shape[0], out_len, cfg.num_channels), float("nan"))
        return {s: v for s in cfg.source_names}

    sep = Separator(cfg, params, forward_fn=nan_forward, device="cpu")
    out_len = sep.out_len
    audio = _audio(out_len * 3)
    out = sep.separate(audio, cfg.expected_sr)
    assert calls == [2, 1]
    for s in cfg.source_names:
        assert np.isnan(out[s]).all(), (wire, s)
        with pytest.raises(ValueError, match="non-finite"):
            write_wav(str(tmp_path / f"{s}.wav"), out[s], cfg.expected_sr)
    fn, _ = sep.resident_sweep(audio.shape[0])
    res, checksum = fn(sep.params, torch.from_numpy(_padded(sep, audio)))
    assert all(torch.isnan(v).all() for v in res.values())
    assert torch.isnan(checksum)


def test_graphs_need_a_card():
    """precompile() captures CUDA graphs and a graphed sweep is one: on a
    CPU Separator both refuse instead of quietly running eagerly."""
    _, _, sep = _pair(**SWEEP)
    with pytest.raises(RuntimeError, match="CUDA graphs"):
        sep.precompile()
    with pytest.raises(RuntimeError, match="CUDA device"):
        sep.resident_sweep(sep.out_len, graphed=True)


def test_resident_sweep_spectrogram_family():
    """The U7 family through the same sweep (BN state, mask and iSTFT, no
    difference source), against separate() and the JAX package's sweep."""
    from waveunet_tpu.models.spectrogram_unet import (
        init_spectrogram_unet as jax_init_spectro)

    kw = dict(num_layers=3, num_frames=768 * 15 + 1024, infer_batch=2,
              infer_num_frames=None, num_initial_filters=4)
    jcfg = jax_get_config("unet_spectrogram", **kw)
    cfg = get_config("unet_spectrogram", **kw)
    jparams, jstate = jax_init_spectro(jax.random.PRNGKey(0), jcfg)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    params = params_from_numpy(to_np(jparams), "cpu")
    state = params_from_numpy(to_np(jstate), "cpu")
    sep = Separator(cfg, params, model_state=state, device="cpu")
    jsep = JaxSeparator(jcfg, jparams, model_state=jstate)
    n = sep.out_len * 2 + 917  # 3 windows: a full batch and a tail
    audio = _audio(n, seed=9)
    host = sep.separate(audio, cfg.expected_sr)
    padded = np.pad(audio, [(sep.pad, sep.pad), (0, 0)])
    fn, positions = sep.resident_sweep(n)
    assert positions.shape[0] == 3
    out, checksum = fn(sep.params, torch.from_numpy(padded))
    assert np.isfinite(float(checksum))
    jout, _ = jsep.resident_sweep(n)[0](jparams, jnp.asarray(padded))
    for s in cfg.source_names:
        np.testing.assert_allclose(out[s].numpy(), host[s], atol=2e-6,
                                   err_msg=s)
        np.testing.assert_allclose(out[s].numpy(), np.asarray(jout[s]),
                                   atol=5e-5, err_msg=s)


def test_engine_stages_the_song_with_the_native_quantiser():
    """The int16 song the engine ships is the JAX package's native
    quantiser's, bit for bit, not np.round's."""
    if not native.available():
        pytest.skip("the JAX package's native host library did not build")
    _, _, sep = _pair(infer_wire_dtype="int16", **SWEEP)
    audio = (0.3 * np.random.default_rng(0).standard_normal(
        (1 << 20, 1))).astype(np.float32)  # a few hundred ties in a million
    staged = sep._stage(audio, audio.shape[0] + 2 * sep.pad).numpy()
    want = native.quantize_int16(np.pad(audio, [(sep.pad, sep.pad), (0, 0)]))
    np.testing.assert_array_equal(staged, want)
    assert (np.round(np.clip(audio, -1, 1) * 32767).astype(np.int16)
            != native.quantize_int16(audio)).any()


@pytest.mark.parametrize("wire", ["float32", "int16"])
def test_stage_resident_pads_and_quantises_as_separate(wire):
    """The song the resident sweep takes comes from separate()'s own
    staging: padded and wire-quantised, and not the host buffer that the
    next request overwrites."""
    _, _, sep = _pair(infer_wire_dtype=wire, **SWEEP)
    audio = _audio(sep.out_len * 3 + 5, seed=3)
    staged = sep.stage_resident(audio)
    want = _padded(sep, audio)
    assert staged.dtype == (torch.int16 if wire == "int16" else torch.float32)
    np.testing.assert_array_equal(staged.numpy(), want)
    sep.separate(_audio(audio.shape[0], seed=4), sep.cfg.expected_sr)
    np.testing.assert_array_equal(staged.numpy(), want)


def test_window_positions_match_jax():
    from waveunet_tpu.infer.engine import window_positions as jax_positions
    for n, out_len in ((1000, 300), (900, 300), (5, 5), (12345, 256)):
        np.testing.assert_array_equal(window_positions(n, out_len),
                                      jax_positions(n, out_len))
