"""ctypes binding of the native C++ audio loader (`loader.cc`, the port's
own copy of `dl4ss_tpu/native/loader.cc`).

At first use `loader.cc` compiles with `g++` into
`dl4ss_tpu_torch/_build/loader-<hash>/`, keyed by a hash of the source and
the flags, and loads with `ctypes`. Nothing builds at import. A failed build
raises with the compiler's output: nothing falls back to the numpy loader
(`data.dirtree._load_fixed`, the plain version the tests hold this one to).
`available()` and `build_error()` report the build, as JAX's do; no caller
in the port branches on them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "loader.cc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
# resampy's kaiser_best beta, as loader.cc's loads use it
KAISER_BETA = 14.769656459379492


def _build(out_dir: Path, cxx: str) -> None:
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
    try:
        cmd = [cxx, *FLAGS, "-o", str(tmp / "libdl4ss_loader.so"),
               str(SOURCE), "-lpthread"]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"native loader build failed:\n$ "
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        try:
            os.replace(tmp, out_dir)
        except OSError:      # another process finished the same build first
            if not (out_dir / "libdl4ss_loader.so").exists():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded loader library, built from `loader.cc` on first call."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the native loader "
                           "cannot build")
    h = hashlib.sha256(" ".join((cxx, *FLAGS)).encode())
    h.update(SOURCE.read_bytes())
    out_dir = BUILD_ROOT / f"loader-{h.hexdigest()[:16]}"
    so = out_dir / "libdl4ss_loader.so"
    if not so.exists():
        _build(out_dir, cxx)
    lib = ctypes.CDLL(str(so))
    f, i, p = ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_char_p
    sigs = {
        "dl4ss_decode_wav": [p, f, i, ctypes.POINTER(ctypes.c_int)],
        "dl4ss_resample_poly": [f, i, i, i, ctypes.c_double, f, i],
        "dl4ss_load_utterance": [p, i, i, i, f],
        "dl4ss_load_batch": [p, i, i, i, i, i, f],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def build_error() -> Optional[str]:
    """Why `library()` cannot build or load (the compiler's output, or the
    loader's error), or None when it can."""
    try:
        library()
    except (RuntimeError, OSError) as e:
        return str(e)
    return None


def available() -> bool:
    """Whether `library()` builds and loads."""
    return build_error() is None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def decode_wav(path) -> Tuple[np.ndarray, int]:
    """(mono float32 samples, rate) of a wav file."""
    lib = library()
    cap = 1 << 22
    out = np.empty(cap, np.float32)
    rate = ctypes.c_int(0)
    n = lib.dl4ss_decode_wav(str(path).encode(), _fptr(out), cap,
                             ctypes.byref(rate))
    if n < 0:
        raise ValueError(f"native decode failed: {path}")
    if n > cap:      # a very long file: again with the exact size
        out = np.empty(n, np.float32)
        n = lib.dl4ss_decode_wav(str(path).encode(), _fptr(out), n,
                                 ctypes.byref(rate))
    return out[:n].copy(), rate.value


def resample_poly(x: np.ndarray, up: int, down: int,
                  beta: float = KAISER_BETA) -> np.ndarray:
    """Polyphase resample of a mono signal by up / down with a Kaiser
    window of `beta` (scipy.signal.resample_poly's filter, summed in
    float64): float32 of length ceil(len(x) * up / down). Raises
    ValueError if the library reports its output buffer too small."""
    x = np.ascontiguousarray(x, np.float32)
    cap = int(len(x) * up / down) + 8
    out = np.empty(cap, np.float32)
    n = library().dl4ss_resample_poly(_fptr(x), len(x), up, down, beta,
                                      _fptr(out), cap)
    if n < 0:
        raise ValueError("native resample buffer overflow")
    return out[:n].copy()


def load_utterance(path, target_rate: int, max_len: int,
                   normalize: bool = False) -> np.ndarray:
    """Decode, resample to `target_rate`, crop (then, with `normalize`,
    mean-subtract and peak-normalize) and zero-pad to `max_len`."""
    out = np.empty(max_len, np.float32)
    n = library().dl4ss_load_utterance(str(path).encode(), target_rate,
                                       max_len, int(normalize), _fptr(out))
    if n < 0:
        raise ValueError(f"native load failed: {path}")
    return out


def load_batch(paths: List, target_rate: int, max_len: int,
               normalize: bool = False,
               num_threads: Optional[int] = None) -> np.ndarray:
    """(len(paths), max_len) float32: `load_utterance` of every path on a
    pool of `num_threads` threads (default: one per path, at most one per
    core). Raises if any file fails."""
    blob = b"\0".join(str(p).encode() for p in paths) + b"\0"
    out = np.empty((len(paths), max_len), np.float32)
    threads = num_threads or min(len(paths), os.cpu_count() or 1)
    fails = library().dl4ss_load_batch(blob, len(paths), target_rate,
                                       max_len, int(normalize), threads,
                                       _fptr(out))
    if fails:
        raise ValueError(f"native batch load: {fails} file(s) failed")
    return out
