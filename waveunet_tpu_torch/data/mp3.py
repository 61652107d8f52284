"""MPEG audio (mp3) decoding through the system libmpg123, bound with ctypes.

A copy of ``waveunet_tpu/data/mp3.py``: the handful of libmpg123 calls that
stream a file out as float32 PCM, used by
:func:`waveunet_tpu_torch.data.audio_io.load` for ``.mp3``, ``.mp2`` and
``.mpga`` files. libmpg123 is the canonical MPEG-1/2/2.5 audio decoder
library and needs no ffmpeg binary.

Decoder properties worth knowing:
  * output is float32 at the stream's native rate and channels;
  * LAME/Xing gapless tags are honoured when present (mpg123's default);
    without them the decoded length includes the codec's leading delay of
    about 1105 samples, the same for every file encoded the same way, so
    stems stay aligned with their mixture, which is what BSS-Eval needs.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional, Tuple

import numpy as np

_MPG123_ENC_FLOAT_32 = 0x200
_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_MPG123_ADD_FLAGS = 2       # mpg123_parms enum
_MPG123_FORCE_FLOAT = 0x400  # param flag: decode to float regardless of source

_lib: Optional[ctypes.CDLL] = None
_lib_err: Optional[str] = None


def _load_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_err
    if _lib is not None or _lib_err is not None:
        return _lib
    name = ctypes.util.find_library("mpg123") or "libmpg123.so.0"
    try:
        lib = ctypes.CDLL(name)
    except OSError as e:  # pragma: no cover - environment without mpg123
        _lib_err = str(e)
        return None
    lib.mpg123_init.restype = ctypes.c_int
    lib.mpg123_new.restype = ctypes.c_void_p
    lib.mpg123_new.argtypes = [ctypes.c_char_p,
                               ctypes.POINTER(ctypes.c_int)]
    lib.mpg123_delete.argtypes = [ctypes.c_void_p]
    lib.mpg123_open.restype = ctypes.c_int
    lib.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.mpg123_close.argtypes = [ctypes.c_void_p]
    lib.mpg123_getformat.restype = ctypes.c_int
    lib.mpg123_getformat.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
    lib.mpg123_format.restype = ctypes.c_int
    lib.mpg123_format.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                  ctypes.c_int, ctypes.c_int]
    lib.mpg123_read.restype = ctypes.c_int
    lib.mpg123_read.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_size_t,
                                ctypes.POINTER(ctypes.c_size_t)]
    lib.mpg123_param.restype = ctypes.c_int
    lib.mpg123_param.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_long, ctypes.c_double]
    lib.mpg123_strerror.restype = ctypes.c_char_p
    lib.mpg123_strerror.argtypes = [ctypes.c_void_p]
    lib.mpg123_init()
    _lib = lib
    return _lib


def available() -> bool:
    return _load_lib() is not None


def decode_mp3(path: str) -> Tuple[np.ndarray, int]:
    """Decode an MPEG audio file to float32 ``(n_frames, n_channels)`` + rate."""
    lib = _load_lib()
    if lib is None:
        raise RuntimeError(f"libmpg123 unavailable: {_lib_err}")
    err = ctypes.c_int(0)
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise RuntimeError(f"mpg123_new failed (err={err.value})")
    try:
        # Must be set BEFORE open: a post-open mpg123_format() call does not
        # retarget the already-negotiated s16 stream (observed: reads keep
        # returning s16 bytes with no NEW_FORMAT signal).
        lib.mpg123_param(h, _MPG123_ADD_FLAGS, _MPG123_FORCE_FLOAT, 0.0)
        if lib.mpg123_open(h, path.encode()) != _MPG123_OK:
            raise RuntimeError(
                f"mpg123_open({path!r}): "
                f"{lib.mpg123_strerror(h).decode(errors='replace')}")
        rate = ctypes.c_long(0)
        n_ch = ctypes.c_int(0)
        enc = ctypes.c_int(0)
        if lib.mpg123_getformat(h, ctypes.byref(rate), ctypes.byref(n_ch),
                                ctypes.byref(enc)) != _MPG123_OK:
            raise RuntimeError(f"mpg123_getformat failed on {path!r}")
        # lock output to float32 at native rate/channels
        lib.mpg123_format_none(h)
        if lib.mpg123_format(h, rate.value, n_ch.value,
                             _MPG123_ENC_FLOAT_32) != _MPG123_OK:
            raise RuntimeError("mpg123_format(float32) rejected")

        chunks = []
        buf = ctypes.create_string_buffer(1 << 18)
        done = ctypes.c_size_t(0)
        while True:
            ret = lib.mpg123_read(h, buf, len(buf), ctypes.byref(done))
            if done.value:
                chunks.append(np.frombuffer(buf.raw[:done.value], "<f4"))
            if ret == _MPG123_DONE:
                break
            if ret not in (_MPG123_OK, _MPG123_NEW_FORMAT):
                raise RuntimeError(
                    f"mpg123_read({path!r}): "
                    f"{lib.mpg123_strerror(h).decode(errors='replace')}")
        if not chunks:
            raise RuntimeError(f"{path!r}: no audio frames decoded")
        pcm = np.concatenate(chunks)
        n = (pcm.shape[0] // n_ch.value) * n_ch.value
        audio = pcm[:n].reshape(-1, n_ch.value)
        return np.ascontiguousarray(audio, np.float32), int(rate.value)
    finally:
        lib.mpg123_close(h)
        lib.mpg123_delete(h)
