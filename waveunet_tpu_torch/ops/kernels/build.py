"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process, all
started together, and the objects are linked by one more ``nvcc`` call into
one shared library with a plain C interface, loaded with ``ctypes``. The
sources include no PyTorch header, so the build takes seconds (a source that
includes ``torch/extension.h`` takes minutes to compile), and it needs
nothing but the CUDA toolkit: no ninja, no PyTorch build machinery.

The library lands in ``_build/`` beside this file (listed in ``.gitignore``)
under a name that carries a hash of the sources and flags: a changed source
builds anew, an unchanged one is loaded as it is. Nothing is built at import
time; the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import NamedTuple, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v")
LINK_FLAGS = (*ARCH_FLAGS, "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class Built(NamedTuple):
    path: str
    seconds: Optional[float]  # None: the library was already built
    log: str                  # nvcc's output (ptxas registers, shared memory)


def find_nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME, else under /usr/local/cuda."""
    candidates = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin); the CUDA kernels cannot build")


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libwaveunet_kernels_{h.hexdigest()[:16]}.so")


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # x, w, bias, y, split workspace (or null), B, L_out, Cin, Cout, K,
    # x batch stride, x time stride, then conv1d_fused.plan_launch's tile_m,
    # tile_n, flat, splits, chunks_per_split, slab_rows, smem_bytes; stream
    lib.conv1d_lrelu_f32.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, i32,
                                     i32, i64, i64, i32, i32, i32, i32, i32,
                                     i32, i32, vp]
    lib.conv1d_lrelu_f32.restype = i32
    # x, w, bias, y, prepared-weight scratch, split workspace (or null), B,
    # L_out, Cin, Cout, K, x batch, channel and time strides, then
    # conv1d_im2col.plan_launch's tile_m, tile_n, flat, taps,
    # splits, chunks_per_split, slab_rows, row, smem_bytes; stream
    lib.conv1d_lrelu_im2col_f32.argtypes = [vp, vp, vp, vp, vp, vp, i32, i32,
                                            i32, i32, i32, i64, i64, i64,
                                            i32, i32, i32, i32, i32, i32,
                                            i32, i32, i32, vp]
    lib.conv1d_lrelu_im2col_f32.restype = i32
    # x, w, y, B, n, C, context, stream
    lib.learned_interp_f32.argtypes = [vp, vp, vp, i32, i32, i32, i32, vp]
    lib.learned_interp_f32.restype = i32
    # x, bank, y, n, C, n_out, p, q, L, kmax, c, start, stream; x fp32 or
    # float64 by the name
    for fn in (lib.resample_poly_f32, lib.resample_poly_f64):
        fn.argtypes = [vp, vp, vp, i64, i32, i64, i64, i64, i64, i32, i64,
                       i64, vp]
        fn.restype = i32
    lib.cuda_error_string.argtypes = [i32]
    lib.cuda_error_string.restype = ctypes.c_char_p


def _run(cmds, what):
    """Run the commands together; raise with the output of the first that
    fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:  # a timeout or an interrupt leaves no compiler running
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for cmd, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}) {what}:\n"
                               f"{' '.join(cmd)}\n{log}")
    return "".join(logs)


def build() -> Built:
    """Compile the library if its hashed file is missing: one nvcc process
    a source, all at once, then one link."""
    path = library_path()
    if os.path.exists(path):
        return Built(path, None, "")
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
            for src in sources()]
    tmp = f"{path}.{tag}"
    t0 = time.perf_counter()
    try:
        log = _run([[nvcc, *COMPILE_FLAGS, "-c", "-o", obj, src]
                    for src, obj in zip(sources(), objs)], "compiling")
        log += _run([[nvcc, *LINK_FLAGS, "-o", tmp, *objs]], "linking")
        os.replace(tmp, path)  # atomic: a concurrent loader never sees half
    finally:
        for f in (*objs, tmp):
            if os.path.exists(f):
                os.unlink(f)
    return Built(path, time.perf_counter() - t0, log)


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build().path)
            _declare(lib)
            _lib = lib
        return _lib


def check(status: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never runs,
    and a later synchronise does not report it). A launcher returns
    cudaErrorInvalidValue for shapes outside its kernel's limits."""
    if status != 0:
        text = load().cuda_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError "
                           f"{status} ({text})")
