"""WAV read and write with numpy and the standard library.

The port's counterpart of the WAV path of ``waveunet_tpu/data/audio_io.py``:
a RIFF reader for PCM 8/16/24/32-bit and IEEE float 32/64-bit (odd chunks
padded, WAVE_FORMAT_EXTENSIBLE), PCM 16-bit or float32 out, and ``load``
with mono downmix and resampling (``ops/resample.py``). ``load`` also
decodes MPEG audio (``.mp3``, ``.mp2``, ``.mpga``) through the system
libmpg123 (``data/mp3.py``). Audio is float32 ``(n_frames, n_channels)``,
in [-1, 1] for PCM. A malformed WAV raises ``ValueError``. The JAX
package's soundfile and ffmpeg fallbacks (other formats, MUSDB stems) are
not ported.
"""

from __future__ import annotations

import os
import struct
import wave
from typing import Optional, Tuple

import numpy as np


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a WAV file as float32 (frames, channels) and its rate."""
    with open(path, "rb") as f:
        hdr12 = f.read(12)
        if len(hdr12) < 12:
            raise ValueError(f"{path}: truncated WAV header")
        riff, _, wave_id = struct.unpack("<4sI4s", hdr12)
        if riff != b"RIFF" or wave_id != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = data = None
        while fmt is None or data is None:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            chunk_id, size = struct.unpack("<4sI", hdr)
            if chunk_id == b"fmt ":
                fmt = f.read(size)
                f.seek(size & 1, 1)  # RIFF pads odd chunks by one byte
            elif chunk_id == b"data":
                data = f.read(size)
                f.seek(size & 1, 1)
            else:
                f.seek(size + (size & 1), 1)
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    if len(fmt) < 16:
        raise ValueError(f"{path}: truncated fmt chunk ({len(fmt)} bytes)")
    tag, n_ch, sr, _, _, bits = struct.unpack("<HHIIHH", fmt[:16])
    if n_ch < 1 or sr < 1:
        # a zero here would surface as a ZeroDivisionError downstream
        raise ValueError(
            f"{path}: invalid WAV header (channels={n_ch}, sample rate={sr})")
    if tag == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
        tag = struct.unpack("<H", fmt[24:26])[0]
    if tag == 1:  # PCM
        if bits == 8:
            x = (np.frombuffer(data, np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 16:
            x = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            b = np.frombuffer(data, np.uint8).reshape(-1, 3).astype(np.int32)
            v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
            x = np.where(v >= 1 << 23, v - (1 << 24), v).astype(np.float32)
            x /= float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(data, "<i4").astype(np.float32) / float(1 << 31)
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    elif tag == 3:  # IEEE float
        if bits not in (32, 64):
            raise ValueError(f"{path}: unsupported float bit depth {bits}")
        x = np.frombuffer(data, "<f4" if bits == 32 else "<f8").astype(
            np.float32)
    else:
        raise ValueError(f"{path}: unsupported WAV format tag {tag}")
    n = (len(x) // n_ch) * n_ch
    return np.ascontiguousarray(x[:n].reshape(-1, n_ch)), sr


def write_wav(path: str, audio: np.ndarray, sr: int,
              subtype: str = "PCM_16") -> None:
    """Write float (frames[, channels]) audio as 16-bit PCM (clipped to
    [-1, 1]) or, with ``subtype="FLOAT"``, as float32 samples."""
    audio = np.asarray(audio)
    if audio.ndim == 1:
        audio = audio[:, None]
    if np.issubdtype(audio.dtype, np.floating) and not np.isfinite(audio).all():
        # a diverged model must fail here, not ship a WAV of garbage PCM
        raise ValueError(f"non-finite samples in audio for {path!r}")
    n_ch = audio.shape[1]
    if subtype == "PCM_16":
        pcm = np.round(np.clip(audio, -1.0, 1.0) * 32767.0).astype("<i2")
        with wave.open(path, "wb") as w:
            w.setnchannels(n_ch)
            w.setsampwidth(2)
            w.setframerate(sr)
            w.writeframes(pcm.tobytes())
    elif subtype == "FLOAT":
        data = audio.astype("<f4").tobytes()
        with open(path, "wb") as f:
            f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
            f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 3, n_ch, sr,
                                          sr * n_ch * 4, n_ch * 4, 32))
            f.write(b"data" + struct.pack("<I", len(data)) + data)
    else:
        raise ValueError(f"unsupported subtype {subtype!r}: use 'PCM_16' or "
                         f"'FLOAT'")


def load(path: str, sr: Optional[int] = None, mono: bool = True
         ) -> Tuple[np.ndarray, int]:
    """Load a WAV or MPEG audio file as float32 (frames, channels): the
    mono downmix averages the channels, and ``sr`` resamples when it
    differs from the file's rate. MPEG audio needs libmpg123
    (``RuntimeError`` without it); other formats raise ``ValueError``."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".wav", ".wave"):
        audio, native_sr = load_wav(path)
    elif ext in (".mp3", ".mp2", ".mpga"):
        from waveunet_tpu_torch.data import mp3
        if not mp3.available():
            raise RuntimeError(f"{path}: decoding MPEG audio needs the "
                               f"system library libmpg123, which is not "
                               f"available")
        audio, native_sr = mp3.decode_mp3(path)
    else:
        raise ValueError(f"{path}: the port reads WAV and MPEG audio "
                         f"(.mp3/.mp2/.mpga) only; the soundfile and "
                         f"ffmpeg decoders are not ported")
    if mono and audio.shape[1] > 1:
        audio = np.mean(audio, axis=1, keepdims=True)
    if sr is not None and sr != native_sr:
        from waveunet_tpu_torch.ops.resample import resample
        audio = resample(audio, native_sr, sr)
        native_sr = sr
    return np.ascontiguousarray(audio, np.float32), native_sr
