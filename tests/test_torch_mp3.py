"""The port's MPEG audio decoding against the JAX package's, on the CPU.

Both bind the system libmpg123 (``data/mp3.py``). The streams are built
here: 20 silent MPEG-1 Layer III frames (header ``FF FB 90 04`` and 413
zero bytes: 23,040 stereo frames at 44,100 Hz), and a non-silent MPEG-1
Layer I stream from seeded bit allocations, scale factors and samples,
mono and stereo. The port's ``decode_mp3`` and ``load`` must give the JAX
package's arrays bit for bit. The tests skip where libmpg123 is absent.
"""

import ctypes.util

import numpy as np
import pytest

from waveunet_tpu.data import mp3 as jax_mp3
from waveunet_tpu.data.audio_io import load as jax_load
from waveunet_tpu_torch.data import audio_io, mp3

LAYER3_SILENT = bytes([0xFF, 0xFB, 0x90, 0x04]) + bytes(413)


def layer1_frame(rng, stereo):
    """One MPEG-1 Layer I frame (384 kbps, 44.1 kHz, no CRC, 416 bytes)
    with signal in subbands 0-2."""
    hdr = bytes([0xFF, 0xFF, 0xC0, 0x00 if stereo else 0xC0])
    nch = 2 if stereo else 1
    alloc = {0: 3, 1: 5, 2: 2}  # subband -> bits a sample, less one
    bits = []

    def put(v, n):
        bits.extend((v >> (n - 1 - i)) & 1 for i in range(n))

    for sb in range(32):
        for _ in range(nch):
            put(alloc.get(sb, 0), 4)
    for sb in range(32):
        for _ in range(nch):
            if sb in alloc:
                put(int(rng.integers(8, 30)), 6)  # scale factor index
    for _ in range(12):
        for sb in range(32):
            for _ in range(nch):
                if sb in alloc:
                    n = alloc[sb] + 1
                    put(int(rng.integers(0, 2 ** n - 1)), n)
    body = np.packbits(np.asarray(bits, np.uint8)).tobytes()
    return hdr + body + bytes(416 - len(hdr) - len(body))


@pytest.fixture
def streams(tmp_path):
    if ctypes.util.find_library("mpg123") is None:
        pytest.skip("libmpg123 is not installed")
    paths = {"layer3_silent": tmp_path / "silent.mp3"}
    paths["layer3_silent"].write_bytes(LAYER3_SILENT * 20)
    for stereo in (False, True):
        rng = np.random.default_rng(3)
        p = tmp_path / f"layer1_{'stereo' if stereo else 'mono'}.mp3"
        p.write_bytes(b"".join(layer1_frame(rng, stereo) for _ in range(30)))
        paths[p.stem] = p
    return {k: str(v) for k, v in paths.items()}


def test_decode_is_the_jax_packages_bit_for_bit(streams):
    assert mp3.available()
    shapes = {}
    for name, path in streams.items():
        got, sr = mp3.decode_mp3(path)
        want, want_sr = jax_mp3.decode_mp3(path)
        assert got.dtype == np.float32 and sr == want_sr == 44100
        np.testing.assert_array_equal(got, want, err_msg=name)
        shapes[name] = got.shape
        if name.startswith("layer1"):
            assert np.abs(got).max() > 0.1, name  # not silence
    assert shapes["layer3_silent"] == (23040, 2)
    assert shapes["layer1_mono"] == (11520, 1)
    assert shapes["layer1_stereo"] == (11520, 2)


@pytest.mark.parametrize("kw", [dict(mono=True), dict(mono=False),
                                dict(sr=22050), dict(sr=8000, mono=False)],
                         ids=["mono", "stereo", "sr22050", "sr8000-stereo"])
def test_load_is_the_jax_packages_bit_for_bit(streams, kw):
    for name, path in streams.items():
        got, sr = audio_io.load(path, **kw)
        want, want_sr = jax_load(path, **kw)
        assert sr == want_sr
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_load_without_libmpg123_names_it(streams, monkeypatch):
    monkeypatch.setattr(mp3, "available", lambda: False)
    with pytest.raises(RuntimeError, match="libmpg123"):
        audio_io.load(streams["layer3_silent"])


def test_load_refuses_other_formats(tmp_path):
    p = tmp_path / "x.flac"
    p.write_bytes(b"fLaC")
    with pytest.raises(ValueError, match="WAV and MPEG"):
        audio_io.load(str(p))
