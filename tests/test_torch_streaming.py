"""The port's StreamingSeparator against offline separation and the JAX
package's stream, on the CPU.

Same shrunken configurations as tests/test_streaming.py. A stream equals the
offline engine at the same window on every sample it can see without future
context (the offline engine right-aligns its last window into real signal).
Batched drains equal serial ones to 1e-6, the JAX package's tolerance, not
bit for bit: the CPU's matmuls sum a batch in another order than a single
window (2.2e-8 measured), and on the card the conv's split-K plan depends on
the batch (``chip_smoke.py`` phase ``stream`` requires bit equality where
the plans agree).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from waveunet_tpu.config import get_config as jax_get_config
from waveunet_tpu.infer.streaming import StreamingSeparator as JaxStream

from waveunet_tpu_torch.compat.params import params_from_numpy
from waveunet_tpu_torch.config import get_config
from waveunet_tpu_torch.infer.engine import Separator
from waveunet_tpu_torch.infer.streaming import StreamingSeparator
from test_torch_model import numpy_params
from torch_cpu import few_threads  # noqa: F401

CONTEXT = dict(num_layers=3, num_frames=256, infer_num_frames=None)


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("baseline_context", **CONTEXT)
    params = numpy_params(cfg)
    rng = np.random.default_rng(1337)
    audio = (0.1 * rng.standard_normal((2000, 1))).astype(np.float32)
    return cfg, params, params_from_numpy(params, "cpu"), audio


def _stream(st, audio, sizes):
    got = {s: [] for s in st.cfg.source_names}
    off, i = 0, 0
    while off < audio.shape[0]:
        n = sizes[i % len(sizes)]
        for s, v in st.push(audio[off:off + n]).items():
            got[s].append(v)
        off, i = off + n, i + 1
    for s, v in st.flush().items():
        got[s].append(v)
    return {s: np.concatenate(v) for s, v in got.items()}


@pytest.mark.parametrize("chunk_size", [37, 256, 999])
def test_stream_matches_offline(setup, chunk_size):
    cfg, _, params, audio = setup
    offline = Separator(cfg, params, device="cpu").separate(
        audio, cfg.expected_sr)
    st = StreamingSeparator(cfg, params, device="cpu")
    got = _stream(st, audio, [chunk_size])
    n_cmp = audio.shape[0] - st.out_len
    for s in cfg.source_names:
        assert got[s].shape == audio.shape
        np.testing.assert_allclose(got[s][:n_cmp], offline[s][:n_cmp],
                                   atol=1e-5, err_msg=s)


@pytest.mark.parametrize("wire", ["float32", "int16"])
def test_stream_matches_jax_stream(setup, wire):
    cfg, nparams, params, audio = setup
    cfg = cfg.replace(infer_wire_dtype=wire)
    jcfg = jax_get_config("baseline_context", infer_wire_dtype=wire, **CONTEXT)
    sizes = [301, 17, 1200]
    got = _stream(StreamingSeparator(cfg, params, batch_windows=4,
                                     device="cpu"), audio, sizes)
    want = _stream(JaxStream(jcfg, jax.tree_util.tree_map(jnp.asarray,
                                                          nparams),
                             batch_windows=4), audio, sizes)
    atol = 2e-5 if wire == "float32" else 1 / 32767 + 1e-7
    for s in cfg.source_names:
        assert got[s].shape == want[s].shape
        np.testing.assert_allclose(got[s], want[s], atol=atol, err_msg=s)


@pytest.mark.parametrize("batch_windows", [2, 4, 8])
def test_batched_stream_matches_serial(setup, batch_windows):
    cfg, _, params, audio = setup
    a = _stream(StreamingSeparator(cfg, params, batch_windows=1,
                                   device="cpu"), audio, [777])
    b = _stream(StreamingSeparator(cfg, params, batch_windows=batch_windows,
                                   device="cpu"), audio, [777])
    for s in cfg.source_names:
        assert a[s].shape == (audio.shape[0], cfg.num_channels)
        np.testing.assert_allclose(a[s], b[s], atol=1e-6, err_msg=s)


def test_batched_stream_batches_drains(setup):
    """A burst of many complete windows drains in power-of-two batches."""
    cfg, _, params, audio = setup
    st = StreamingSeparator(cfg, params, batch_windows=4, device="cpu")
    calls = []
    real = st._drain_k
    st._drain_k = lambda k: calls.append(k) or real(k)
    st.push(audio)
    st.flush()
    assert max(calls) > 1, calls
    assert all(k in (1, 2, 4) for k in calls), calls


def test_stream_incremental_availability(setup):
    cfg, _, params, audio = setup
    st = StreamingSeparator(cfg, params, device="cpu")
    out = st.push(audio[:st.out_len // 2])
    assert out[cfg.source_names[0]].shape == (0, cfg.num_channels)
    need = st.in_len - st.pad - st.out_len // 2
    out = st.push(audio[st.out_len // 2:st.out_len // 2 + need])
    assert out[cfg.source_names[0]].shape[0] == st.out_len


def test_stream_reset_and_latency(setup):
    cfg, _, params, audio = setup
    st = StreamingSeparator(cfg, params, device="cpu")
    st.push(audio[:500])
    st.reset()
    out = st.push(audio[:10])
    assert out[cfg.source_names[0]].shape[0] == 0
    assert st.latency_samples == st.out_len + st.pad
    assert st.flush()[cfg.source_names[0]].shape[0] == 10
    assert st.flush()[cfg.source_names[0]].shape[0] == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_stream_fuzz_random_chunks(setup, seed):
    """Chunk sizes from 1 sample to three times the largest piece drive the
    ring through every append and drain interleaving."""
    cfg, _, params, audio = setup
    offline = Separator(cfg, params, device="cpu").separate(
        audio, cfg.expected_sr)
    st = StreamingSeparator(cfg, params, batch_windows=2, device="cpu")
    rng = np.random.default_rng(seed)
    sizes = [int(rng.integers(1, 3 * st._max_piece)) for _ in range(40)]
    got = _stream(st, audio, sizes)
    n_cmp = audio.shape[0] - st.out_len
    for s in cfg.source_names:
        assert got[s].shape == audio.shape
        np.testing.assert_allclose(got[s][:n_cmp], offline[s][:n_cmp],
                                   atol=1e-5, err_msg=s)


def test_stream_learned_stereo_matches_offline():
    kw = dict(num_layers=3, num_initial_filters=4, num_frames=256,
              infer_num_frames=None)
    cfg = get_config("full_44KHz", **kw)
    params = params_from_numpy(numpy_params(cfg), "cpu")
    audio = (0.2 * np.random.default_rng(4).standard_normal(
        (3000, 2))).astype(np.float32)
    offline = Separator(cfg, params, device="cpu").separate(audio, 44100)
    st = StreamingSeparator(cfg, params, batch_windows=4, device="cpu")
    got = _stream(st, audio, [333, 1001])
    n_cmp = audio.shape[0] - st.out_len
    for s in cfg.source_names:
        np.testing.assert_allclose(got[s][:n_cmp], offline[s][:n_cmp],
                                   atol=1e-5, err_msg=s)


@pytest.mark.parametrize("batch_windows", [1, 4])
def test_stream_spectrogram_matches_offline(batch_windows):
    """U7 streams through the same ring with zero context pad."""
    from waveunet_tpu_torch.models.spectrogram_unet import (
        init_spectrogram_unet)
    import torch

    cfg = get_config("unet_spectrogram", num_layers=3,
                     num_frames=768 * 15 + 1024, infer_batch=2,
                     infer_num_frames=None, num_initial_filters=4)
    params, state = init_spectrogram_unet(torch.Generator().manual_seed(0),
                                          cfg, "cpu")
    offline = Separator(cfg, params, model_state=state, device="cpu")
    n = int(offline.out_len * 2.6)
    audio = (0.2 * np.random.default_rng(7).standard_normal(
        (n, 1))).astype(np.float32)
    want = offline.separate(audio, cfg.expected_sr)
    st = StreamingSeparator(cfg, params, batch_windows=batch_windows,
                            model_state=state, device="cpu")
    assert st.pad == 0
    got = _stream(st, audio, [1111])
    n_cmp = n - st.out_len
    for s in cfg.source_names:
        assert got[s].shape == (n, 1) and np.isfinite(got[s]).all()
        np.testing.assert_allclose(got[s][:n_cmp], want[s][:n_cmp],
                                   atol=1e-5, err_msg=s)


def test_stream_nonfinite_output_not_laundered(setup):
    cfg, nparams, _, audio = setup
    cfg16 = cfg.replace(infer_wire_dtype="int16")
    bad = {k: {n: np.full_like(a, np.nan) for n, a in v.items()}
           for k, v in nparams.items()}
    st = StreamingSeparator(cfg16, params_from_numpy(bad, "cpu"),
                            device="cpu")
    outs = [st.push(audio[:512]), st.flush()]
    for out in outs:
        for s in cfg.source_names:
            if out[s].size:
                assert np.isnan(out[s]).all(), s
    assert sum(o[cfg.source_names[0]].shape[0] for o in outs) == 512


def test_stream_rejects_wrong_channel_count(setup):
    cfg, _, params, _ = setup
    st = StreamingSeparator(cfg, params, device="cpu")
    with pytest.raises(ValueError, match="channels"):
        st.push(np.zeros((10, 2), np.float32))
