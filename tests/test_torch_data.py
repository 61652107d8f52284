"""The port's data path against the JAX package's, on the CPU.

WAV I/O, the npz song cache (each package reads the other's), MUSDB and
CCMixter ingest, the host ``BatchPipeline`` (the same batches bit for bit
from the same seed and cache), the device banks (the same int16 bytes, the
same batch assembly from given windows and scales, the same evaluation
windows and loss at 2e-5 relative), and the device sampler, held
statistically and for reproducibility since its draws are not
``jax.random``'s.
"""

import os
import struct

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from waveunet_tpu.config import get_config as jax_get_config
from waveunet_tpu.data import cache as jax_cache
from waveunet_tpu.data import device_cache as jax_dc
from waveunet_tpu.data import ingest as jax_ingest
from waveunet_tpu.data.audio_io import load as jax_load
from waveunet_tpu.data.audio_io import write_wav as jax_write_wav
from waveunet_tpu.data.pipeline import BatchPipeline as JaxPipeline
from waveunet_tpu.models.waveunet import init_waveunet as jax_init

from waveunet_tpu_torch.compat.params import params_from_numpy
from waveunet_tpu_torch.config import get_config
from waveunet_tpu_torch.data import cache, device_cache, ingest
from waveunet_tpu_torch.data.audio_io import load, load_wav, write_wav
from waveunet_tpu_torch.data.device_cache import DeviceBank, EvalBank
from waveunet_tpu_torch.data.pipeline import BatchPipeline, EmptyShardError
from waveunet_tpu_torch.models.waveunet import init_waveunet
from waveunet_tpu_torch.ops import shapes
from torch_cpu import few_threads  # noqa: F401

SMALL = dict(num_layers=3, num_initial_filters=4, num_frames=256,
             batch_size=2, num_snippets_per_track=4, cache_size=8,
             num_workers=1)


def small_cfgs(tmp_path, preset="full_44KHz", **over):
    kw = dict(SMALL, data_path=str(tmp_path / "cache"), **over)
    return get_config(preset, **kw), jax_get_config(preset, **kw)


def write_songs(tmp_path, cfg, n_songs=3, seconds=0.5, seed=0,
                clip_mix=False):
    """Sine-and-noise stems as float WAVs, cached for every partition with
    the port's preprocess; returns the context pad."""
    in_len, out_len = shapes.get_padding(cfg, cfg.num_frames)
    pad = (in_len - out_len) // 2
    rng = np.random.default_rng(seed)
    for part in ("train", "valid", "test"):
        samples = []
        for i in range(n_songs):
            n = int(cfg.expected_sr * seconds) + 97 * i
            t = np.arange(n) / cfg.expected_sr
            tracks = {}
            for name in cfg.source_names:
                sig = (0.4 * np.sin(2 * np.pi * rng.uniform(100, 900) * t)
                       + 0.1 * rng.standard_normal(n)).astype(np.float32)
                tracks[name] = np.tile(sig[:, None], (1, cfg.num_channels))
            mix = sum(tracks.values())
            tracks["mix"] = np.clip(mix, -0.6, 0.6) if clip_mix else mix
            d = tmp_path / "wav" / part
            d.mkdir(parents=True, exist_ok=True)
            paths = {}
            for k, v in tracks.items():
                paths[k] = str(d / f"s{i}_{k}.wav")
                write_wav(paths[k], v, cfg.expected_sr, subtype="FLOAT")
            samples.append(paths)
        cache.preprocess_partition(cfg, part, samples, pad_frames=pad)
    return pad


# -- WAV ---------------------------------------------------------------------

@pytest.mark.parametrize("subtype", ["FLOAT", "PCM_16"])
def test_wav_round_trip_both_ways(tmp_path, subtype):
    rng = np.random.default_rng(0)
    audio = rng.uniform(-0.9, 0.9, (1001, 2)).astype(np.float32)
    port, jaxp = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    write_wav(port, audio, 22050, subtype=subtype)
    jax_write_wav(jaxp, audio, 22050, subtype=subtype)
    with open(port, "rb") as f, open(jaxp, "rb") as g:
        assert f.read() == g.read()
    got, sr = load_wav(port)
    want, _ = jax_load(port, sr=None, mono=False)
    assert sr == 22050 and got.shape == (1001, 2)
    np.testing.assert_array_equal(got, want)
    if subtype == "FLOAT":
        np.testing.assert_array_equal(got, audio)


def test_load_downmixes_and_resamples_like_jax(tmp_path):
    rng = np.random.default_rng(1)
    audio = (0.5 * rng.standard_normal((4410, 2))).astype(np.float32)
    p = str(tmp_path / "x.wav")
    write_wav(p, audio, 44100, subtype="FLOAT")
    for sr, mono in ((None, True), (22050, True), (16000, False)):
        got, gsr = load(p, sr=sr, mono=mono)
        want, wsr = jax_load(p, sr=sr, mono=mono)
        assert gsr == wsr and got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_wav_odd_data_chunk_before_fmt(tmp_path):
    data = bytes([128, 255, 0])  # three 8-bit samples: an odd chunk
    fmt = struct.pack("<HHIIHH", 1, 1, 8000, 8000, 1, 8)
    body = (struct.pack("<4sI", b"data", len(data)) + data + b"\x00"
            + struct.pack("<4sI", b"fmt ", len(fmt)) + fmt)
    p = tmp_path / "odd.wav"
    p.write_bytes(struct.pack("<4sI4s", b"RIFF", 4 + len(body), b"WAVE")
                  + body)
    audio, sr = load_wav(str(p))
    assert sr == 8000 and audio.shape == (3, 1)
    np.testing.assert_allclose(audio[:, 0],
                               (np.array([128, 255, 0]) - 128) / 128.0)


def _wav_blob(n_ch=1, sr=8000, bits=16, data=b"\x00\x00" * 10, fmt_len=16):
    fmt = struct.pack("<HHIIHH", 1, n_ch, sr, sr * n_ch * bits // 8,
                      max(n_ch * bits // 8, 1), bits)[:fmt_len]
    body = (b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", len(data)) + data)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body


MALFORMED = {
    "zero_channels.wav": lambda: _wav_blob(n_ch=0),
    "zero_sr.wav": lambda: _wav_blob(sr=0),
    "empty.wav": lambda: b"",
    "tiny.wav": lambda: b"RIFF",
    "short_fmt.wav": lambda: _wav_blob(fmt_len=8),
}


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_malformed_wavs_raise_valueerror_as_jax(tmp_path, name):
    p = tmp_path / name
    p.write_bytes(MALFORMED[name]())
    with pytest.raises(ValueError):
        jax_load(str(p), sr=22050)
    with pytest.raises(ValueError):
        load(str(p), sr=22050)


def test_write_nonfinite_raises(tmp_path):
    for val in (np.nan, np.inf):
        with pytest.raises(ValueError, match="non-finite"):
            write_wav(str(tmp_path / "x.wav"),
                      np.full((10, 1), val, np.float32), 8000)


# -- the song cache ----------------------------------------------------------

def test_cache_is_read_by_both_packages(tmp_path):
    cfg, jcfg = small_cfgs(tmp_path)
    pad = write_songs(tmp_path, cfg)
    assert cache.cache_dir(cfg) == jax_cache.cache_dir(jcfg)
    assert cache.is_prepared(cfg) and jax_cache.is_prepared(jcfg)
    for part in ("train", "valid", "test"):
        assert cache.list_songs(cfg, part) == jax_cache.list_songs(jcfg, part)
    song = cache.list_songs(cfg, "train")[0]
    got, want = cache.load_song(song), jax_cache.load_song(song)
    assert set(got) == set(want) == {"vocals", "accompaniment", "mix"}
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
        assert not got[k][:pad].any() and not got[k][-pad:].any()

    # and the JAX package's preprocess of the same WAVs is the same cache
    jcfg2 = jcfg.replace(data_path=str(tmp_path / "jax_cache"))
    samples = [{k: str(tmp_path / "wav" / "train" / f"s{i}_{k}.wav")
                for k in ("vocals", "accompaniment", "mix")}
               for i in range(3)]
    jax_cache.preprocess_partition(jcfg2, "train", samples, pad)
    for a, b in zip(jax_cache.list_songs(jcfg2, "train"),
                    cache.list_songs(cfg, "train")):
        x, y = cache.load_song(a), cache.load_song(b)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


def test_corrupt_shard_raises_and_is_skipped(tmp_path, capsys):
    cfg, _ = small_cfgs(tmp_path)
    write_songs(tmp_path, cfg)
    in_len, out_len = shapes.get_padding(cfg, cfg.num_frames)
    bad = cache.list_songs(cfg, "train")[1]
    with open(bad, "wb") as f:
        f.write(b"PK\x03\x04 not a zip")
    with pytest.raises(ValueError, match="corrupt cache shard"):
        cache.load_song(bad)
    bank = DeviceBank(cfg, "train", in_len, out_len, device="cpu")
    assert bank.n_songs == 2
    assert "corrupt cache shard" in capsys.readouterr().out
    ev = EvalBank(cfg, "train", in_len, out_len, device="cpu")
    assert ev.n_windows > 0


def test_is_prepared_needs_every_completion_marker(tmp_path):
    cfg, _ = small_cfgs(tmp_path)
    for p in ("train", "valid"):
        os.makedirs(cache.partition_dir(cfg, p))
        open(os.path.join(cache.partition_dir(cfg, p), "meta.json"),
             "w").close()
    assert not cache.is_prepared(cfg)
    os.makedirs(cache.partition_dir(cfg, "test"))
    assert not cache.is_prepared(cfg)


# -- ingest ------------------------------------------------------------------

def _musdb_tree(root, sr=8000, n=800):
    rng = np.random.default_rng(2)
    for part, songs in (("train", ("a", "b", "c")), ("test", ("d",))):
        for song in songs:
            d = root / part / song
            d.mkdir(parents=True)
            stems = {s: (0.3 * rng.standard_normal((n, 2))).astype(np.float32)
                     for s in ("bass", "drums", "other", "vocals")}
            for s, v in stems.items():
                write_wav(str(d / f"{s}.wav"), v, sr)
            write_wav(str(d / "mixture.wav"), sum(stems.values()), sr)


def test_musdb_wav_layout_ingests_as_jax(tmp_path):
    _musdb_tree(tmp_path / "port")
    _musdb_tree(tmp_path / "jax")
    got_train, got_test = ingest.get_musdb(str(tmp_path / "port"))
    want_train, want_test = jax_ingest.get_musdb(str(tmp_path / "jax"))
    rel = lambda lst, root: [{k: os.path.relpath(v, root)  # noqa: E731
                              for k, v in s.items()} for s in lst]
    assert rel(got_train, tmp_path / "port") == rel(want_train,
                                                    tmp_path / "jax")
    assert rel(got_test, tmp_path / "port") == rel(want_test, tmp_path / "jax")
    for g, w in zip(got_train + got_test, want_train + want_test):
        with open(g["accompaniment"], "rb") as f, \
                open(w["accompaniment"], "rb") as h:
            assert f.read() == h.read()


def test_ccmixter_manifest_parses_as_jax(tmp_path):
    xml = tmp_path / "cc.xml"
    xml.write_text(
        "<ccmixter><databaseFolderPath>/db</databaseFolderPath>"
        + "".join(
            f"<track>"
            f"<instrument><instrumentName>Mix</instrumentName>"
            f"<relativeFilepath>t{i}/mix.wav</relativeFilepath></instrument>"
            f"<instrument><instrumentName>Voice</instrumentName>"
            f"<relativeFilepath>t{i}/v.wav</relativeFilepath></instrument>"
            + ("" if i == 1 else
               f"<instrument><instrumentName>Instrumental</instrumentName>"
               f"<relativeFilepath>t{i}/i.wav</relativeFilepath>"
               f"</instrument>")
            + "</track>" for i in range(3))
        + "</ccmixter>")
    got = ingest.get_ccmixter(str(xml))
    assert got == jax_ingest.get_ccmixter(str(xml))
    assert len(got) == 2


# -- the host pipeline -------------------------------------------------------

@pytest.mark.parametrize("augmentation", [True, False])
def test_batch_pipeline_matches_jax_bit_for_bit(tmp_path, augmentation):
    cfg, jcfg = small_cfgs(tmp_path, augmentation=augmentation)
    write_songs(tmp_path, cfg, clip_mix=True)
    in_len, out_len = shapes.get_padding(cfg, cfg.num_frames)
    for part in ("train", "valid"):
        got = BatchPipeline(cfg, part, in_len, out_len, seed=5)
        want = JaxPipeline(jcfg, part, in_len, out_len, seed=5)
        gt, wt = got.train_batches(), want.train_batches()
        for _ in range(6):
            g, w = next(gt), next(wt)
            assert set(g) == set(w)
            for k in w:
                assert g[k].dtype == w[k].dtype == np.float32
                np.testing.assert_array_equal(g[k], w[k])
        ge, we = list(got.eval_batches()), list(want.eval_batches())
        assert len(ge) == len(we) > 0
        for g, w in zip(ge, we):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])


def test_pipeline_host_slices_and_errors(tmp_path):
    cfg, _ = small_cfgs(tmp_path)
    write_songs(tmp_path, cfg)
    in_len, out_len = shapes.get_padding(cfg, cfg.num_frames)
    a = BatchPipeline(cfg, "train", in_len, out_len, host_id=0, num_hosts=2)
    b = BatchPipeline(cfg, "train", in_len, out_len, host_id=1, num_hosts=2)
    assert sorted(a.paths + b.paths) == cache.list_songs(cfg, "train")
    with pytest.raises(EmptyShardError):
        BatchPipeline(cfg, "train", in_len, out_len, host_id=3, num_hosts=4)

    def boom():
        yield 1
        raise RuntimeError("reader failed")
    with pytest.raises(RuntimeError, match="reader failed"):
        list(a.prefetched(boom()))


# -- the device banks --------------------------------------------------------

@pytest.mark.parametrize("augmentation", [True, False])
def test_int16_bank_is_the_jax_bank(tmp_path, augmentation):
    cfg, jcfg = small_cfgs(tmp_path, augmentation=augmentation)
    write_songs(tmp_path, cfg, clip_mix=True)
    in_len, out_len = shapes.get_padding(cfg, cfg.num_frames)
    got = DeviceBank(cfg, "train", in_len, out_len, device="cpu")
    want = jax_dc.DeviceBank(jcfg, "train", in_len, out_len)
    bank, starts, valids = got.arrays
    wbank, wstarts, wvalids = want.arrays
    assert bank.dtype == torch.int16
    assert bank.shape == tuple(wbank.shape) == (
        cfg.num_sources + (0 if augmentation else 1),) + bank.shape[1:]
    assert bank.numpy().tobytes() == np.asarray(wbank).tobytes()
    np.testing.assert_array_equal(starts.numpy(), np.asarray(wstarts))
    np.testing.assert_array_equal(valids.numpy(), np.asarray(wvalids))
    assert got.nbytes() == want.nbytes()


@pytest.mark.parametrize("mode", ["augment", "plain", "stored_mix"])
def test_assemble_batch_matches_jax(mode):
    cfg = get_config("full_multi_instrument", num_layers=3, num_frames=256)
    jcfg = jax_get_config("full_multi_instrument", num_layers=3,
                          num_frames=256)
    S = cfg.num_sources
    rows = S + (1 if mode == "stored_mix" else 0)
    rng = np.random.default_rng(4)
    wins = (rng.integers(-32767, 32768, (3, rows, 300, 1)) / 32767.0).astype(
        np.float32)
    k_amp = jax.random.PRNGKey(9)
    scale = np.array(jax.random.uniform(k_amp, (3, S, 1, 1),
                                          minval=0.7, maxval=1.0))
    augment = mode == "augment"
    want = jax_dc._assemble_batch(jcfg, jnp.asarray(wins), k_amp, 20, 256,
                                  augment, stored_mix=mode == "stored_mix")
    got = device_cache._assemble_batch(cfg, torch.from_numpy(wins),
                                       torch.from_numpy(scale), 20, 256,
                                       augment,
                                       stored_mix=mode == "stored_mix")
    assert set(got) == set(want)
    for k in want:
        if k == "mix" and augment:
            # XLA sums the four scaled sources in another order
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=0, atol=4e-7)
        else:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_assemble_batch_two_sources_is_exact():
    cfg, jcfg = get_config("full_44KHz"), jax_get_config("full_44KHz")
    rng = np.random.default_rng(6)
    wins = (rng.integers(-32767, 32768, (4, 2, 120, 2)) / 32767.0).astype(
        np.float32)
    k_amp = jax.random.PRNGKey(3)
    scale = np.array(jax.random.uniform(k_amp, (4, 2, 1, 1), minval=0.7,
                                          maxval=1.0))
    want = jax_dc._assemble_batch(jcfg, jnp.asarray(wins), k_amp, 10, 100,
                                  True)
    got = device_cache._assemble_batch(cfg, torch.from_numpy(wins),
                                       torch.from_numpy(scale), 10, 100, True)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_sampler_batch_is_the_bank_at_its_positions(tmp_path):
    """A sampled batch is the bank's windows at the drawn positions, scaled
    by the drawn scales, assembled as JAX's ``_assemble_batch``."""
    cfg, jcfg = small_cfgs(tmp_path)
    write_songs(tmp_path, cfg)
    in_len, out_len = shapes.get_padding(cfg, cfg.num_frames)
    bank = DeviceBank(cfg, "train", in_len, out_len, batch_size=5,
                      device="cpu")
    b, starts, valids = bank.arrays
    d = device_cache.draws(11, 42, 5, 4, torch.device("cpu"))
    _, pos = device_cache.positions(d, starts, valids)
    idx = pos.numpy()[:, None] + np.arange(in_len)
    wins = np.transpose(b.numpy()[:, idx], (1, 0, 2, 3)).astype(
        np.float32) / np.float32(32767.0)
    scale = (device_cache.uniform01(d[:, 2:4]) * (1.0 - 0.7) + 0.7).numpy()
    got = bank.sample(11, 42)
    pad = (in_len - out_len) // 2
    np.testing.assert_array_equal(
        got["mix"].numpy(), (wins * scale[:, :, None, None]).sum(axis=1))
    for i, name in enumerate(cfg.source_names):
        np.testing.assert_array_equal(
            got[name].numpy(),
            (wins[:, i] * scale[:, i, None, None])[:, pad:pad + out_len])
    assert got["mix"].shape == (5, in_len, cfg.num_channels)


def test_sampler_statistics():
    """Songs uniform, starts uniform over [0, max(valid, 1)) of their song
    (a zero valid range gives start 0), scales in [0.7, 1.0)."""
    starts = torch.tensor([0, 1000, 1010, 50_000], dtype=torch.int64)
    valids = torch.tensor([900, 0, 40_000, 7], dtype=torch.int64)
    songs, offs, scales = [], [], []
    for step in range(400):
        d = device_cache.draws(3, step, 64, 4, torch.device("cpu"))
        song, pos = device_cache.positions(d, starts, valids)
        songs.append(song)
        offs.append(pos - starts[song])
        scales.append(device_cache.uniform01(d[:, 2:]) * 0.3 + 0.7)
    song, off = torch.cat(songs), torch.cat(offs)
    scale = torch.cat(scales)
    n = song.numel()
    counts = torch.bincount(song, minlength=4).double() / n
    assert torch.all((counts - 0.25).abs() < 0.01), counts
    for s in range(4):
        o = off[song == s].double()
        hi = max(int(valids[s]), 1)
        assert o.min() >= 0 and o.max() < hi
        if hi > 1:
            # uniform over [0, hi): mean and spread of a discrete uniform
            assert abs(o.mean().item() / (hi - 1) - 0.5) < 0.02
            assert o.max() >= 0.99 * (hi - 1) and o.min() <= 0.01 * hi
    assert torch.all(off[song == 1] == 0)
    assert scale.min() >= 0.7 and scale.max() < 1.0
    assert abs(scale.mean().item() - 0.85) < 0.003


def test_sampler_is_a_function_of_the_step(tmp_path):
    cfg, _ = small_cfgs(tmp_path)
    write_songs(tmp_path, cfg)
    in_len, out_len = shapes.get_padding(cfg, cfg.num_frames)
    a = DeviceBank(cfg, "train", in_len, out_len, device="cpu")
    b = DeviceBank(cfg, "train", in_len, out_len, device="cpu")
    x, y = a.sample(5, 17), b.sample(5, torch.tensor(17))
    for k in x:
        assert torch.equal(x[k], y[k])
    assert not torch.equal(a.sample(5, 18)["mix"], x["mix"])
    assert not torch.equal(a.sample(6, 17)["mix"], x["mix"])
    it = a.batches(5, start=15)
    next(it), next(it)
    assert torch.equal(next(it)["mix"], x["mix"])


def test_eval_bank_windows_and_loss_match_jax(tmp_path):
    cfg, jcfg = small_cfgs(tmp_path, batch_size=3)
    write_songs(tmp_path, cfg, clip_mix=True, seconds=0.7)
    in_len, out_len = shapes.get_padding(cfg, cfg.num_frames)
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    for dtype in ("int16", "float32"):
        got = EvalBank(cfg, "valid", in_len, out_len, dtype=dtype,
                       device="cpu")
        want = jax_dc.EvalBank(jcfg, "valid", in_len, out_len, dtype=dtype)
        np.testing.assert_array_equal(got.positions, want._positions)
        assert (got.n_windows, got.n_batches) == (want.n_windows,
                                                  want.n_batches)
        gl = got.evaluate(params, {})
        wl = want.evaluate(jparams, {})
        assert abs(gl - wl) <= 2e-5 * abs(wl), (dtype, gl, wl)
        # re-chunked without another upload: the remainder moves
        got.set_batch(2)
        want.set_batch(2)
        assert got.n_batches == want.n_batches
        assert abs(got.evaluate(params, {}) - want.evaluate(jparams, {})) \
            <= 2e-5 * abs(wl)


def test_eval_bank_set_batch_drops_captured_sweeps(tmp_path):
    """A captured sweep gathers through the bank's index buffer, which
    set_batch replaces: re-setting even the same batch drops the graphs, and
    the sweep after it is the one a fresh bank at that batch gives."""
    cfg, _ = small_cfgs(tmp_path, batch_size=3)
    write_songs(tmp_path, cfg, seconds=0.7)
    in_len, out_len = shapes.get_padding(cfg, cfg.num_frames)
    params = init_waveunet(torch.Generator().manual_seed(0), cfg, "cpu")
    ev = EvalBank(cfg, "valid", in_len, out_len, device="cpu")
    ev.set_batch(2)
    ev._graphs[(2, ())] = "a sweep captured at batch 2"
    ev.set_batch(2)
    assert ev._graphs == {}
    fresh = EvalBank(cfg, "valid", in_len, out_len, batch_size=2,
                     device="cpu")
    np.testing.assert_array_equal(ev.batch_losses(params, {}),
                                  fresh.batch_losses(params, {}))


def test_eval_bank_batches_are_the_pipeline_eval_batches(tmp_path):
    cfg, _ = small_cfgs(tmp_path, batch_size=3)
    write_songs(tmp_path, cfg, clip_mix=True, seconds=0.7)
    in_len, out_len = shapes.get_padding(cfg, cfg.num_frames)
    ev = EvalBank(cfg, "valid", in_len, out_len, dtype="float32",
                  device="cpu")
    pipe = list(BatchPipeline(cfg, "valid", in_len, out_len).eval_batches())
    assert len(pipe) == ev.n_batches > 1
    for i, want in enumerate(pipe):
        got = ev.batch_at(i)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_banks_raise_without_songs_and_over_budget(tmp_path):
    cfg, _ = small_cfgs(tmp_path)
    in_len, out_len = shapes.get_padding(cfg, cfg.num_frames)
    with pytest.raises(FileNotFoundError):
        DeviceBank(cfg, "train", in_len, out_len, device="cpu")
    write_songs(tmp_path, cfg)
    with pytest.raises(ValueError, match="budget"):
        DeviceBank(cfg, "train", in_len, out_len, max_bytes=100,
                   device="cpu")
    with pytest.raises(ValueError, match="budget"):
        EvalBank(cfg, "valid", in_len, out_len, max_bytes=100, device="cpu")
    with pytest.raises(ValueError, match="no song long enough"):
        DeviceBank(cfg, "train", 10 ** 6, 10 ** 6 - 100, device="cpu")
