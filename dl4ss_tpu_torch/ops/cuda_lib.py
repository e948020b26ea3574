"""Build, load and launch the hand-written CUDA kernels of `csrc/`.

At first use each `csrc/*.cu` compiles to an object with its own `nvcc`
(all started together), and the objects link into one shared library with a
plain C interface for `sm_90a`. The library lands in `_build/<hash>/`,
keyed by a hash of the sources and flags, and is loaded with `ctypes`.
Nothing here runs at import: this module imports on a machine without a
GPU or `nvcc`, and only a launch on a CUDA tensor builds.

Every C entry point takes its tensors as `void*` (`Tensor.data_ptr()`), its
sizes as `int`, and PyTorch's current stream last; it returns the
`cudaGetLastError()` of its launches, which `launch` turns into an
exception. `LAUNCHES` counts, per kernel, the wrapper calls that launched it;
a CUDA graph's capture records launches that run at each replay, so the
graph's owner takes them out with `uncounted` and adds them per replay with
`count`.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List, NamedTuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("stft_features.cu", "gru_fwd.cu", "maskhead_fwd.cu",
           "masked_istft.cu", "gru_bwd.cu", "maskhead_bwd.cu", "lstm_fwd.cu",
           "lstm_bwd.cu", "stft_ri.cu", "istft_ri.cu")
HEADERS = ("dl4ss_common.cuh", "maskhead_tile.cuh", "rnn_resident.cuh",
           "rnn_bwd_common.cuh", "rnn_fwd_common.cuh", "rnn_fwd_wide.cuh",
           "rnn_fwd_tiled.cuh", "fft_stages.cuh", "stft_tile.cuh",
           "istft_tile.cuh")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# C signature of each kernel entry point: p = pointer, i = int. The stream
# is appended as a pointer; every function returns an int error code.
SIGNATURES = {
    "stft_features": "ppppppppiiiiiiii",
    "gru_fwd": "pppppiiiiiiiii",
    "maskhead_fwd": "pppppiiiiiii",
    "maskhead_pack": "ppiiii",       # K3's weight layout, once per W version
    "masked_istft": "ppppppppiiiiiiiii",
    "gru_bwd": "ppppppppppppppiiiiiiiii",
    "maskhead_bwd": "ppppppppppiiiiii",
    "lstm_fwd": "ppppppiiiiiiiii",
    "lstm_bwd": "pppppppppppppiiiiiiiii",
    "stft_ri": "ppppppiiiiiii",
    "istft_ri": "ppppppiiiiiii",
}
# The ports of the TPU kernels that a serving call with given speakers
# launches every time, those a joint training step does (its loss
# resynthesises through the plain iSTFT, as in JAX), those a serving call
# adds when the classifier selects the speakers, and those a classifier
# training step launches.
SERVING_KERNELS = ("stft_features", "gru_fwd", "maskhead_fwd", "masked_istft")
TRAINING_KERNELS = ("stft_features", "gru_fwd", "maskhead_fwd", "gru_bwd",
                    "maskhead_bwd")
SELECTION_KERNELS = (*SERVING_KERNELS, "lstm_fwd")
CLASSIFIER_KERNELS = ("stft_features", "lstm_fwd", "lstm_bwd")
# Plain C queries (no launch, no stream): ints in, a 64-bit count out.
QUERIES = {"maskhead_packed_size": "iii", "maskhead_bwd_partials": "iiiiii",
           "gru_fwd_clusters": "iii", "lstm_fwd_clusters": "iii"}

LAUNCHES: collections.Counter = collections.Counter()
# Every launch counter: LAUNCHES and the BODY_LAUNCHES of the kernel modules
# (each appends its own), which `uncounted` and `count` keep together.
COUNTERS: List[collections.Counter] = [LAUNCHES]


class KernelLibrary(NamedTuple):
    dll: ctypes.CDLL
    path: Path
    build_seconds: float   # 0.0 when an earlier build was reused
    log: str               # nvcc / ptxas output of the build


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot build")


def _source_hash(nvcc: str) -> str:
    h = hashlib.sha256(" ".join((nvcc, *NVCC_FLAGS)).encode())
    for name in (*HEADERS, *SOURCES):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds) -> str:
    """Run the commands in parallel; raise with their output if any fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    failed = [(c, o) for c, p, o in zip(cmds, procs, outs) if p.returncode]
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(
            f"$ {' '.join(c)}\n{o}" for c, o in failed))
    return "".join(outs)


def _build(out_dir: Path, nvcc: str) -> str:
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
    try:
        objs = [tmp / (src + ".o") for src in SOURCES]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o",
                         str(obj)] for src, obj in zip(SOURCES, objs)])
        log += _run_all([[nvcc, *ARCH, "-shared", "-o",
                          str(tmp / "libdl4ss_kernels.so"),
                          *map(str, objs)]])
        (tmp / "build.log").write_text(log)
        try:
            os.replace(tmp, out_dir)
        except OSError:      # another process finished the same build first
            if not (out_dir / "libdl4ss_kernels.so").exists():
                raise
        return log
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


@functools.lru_cache(maxsize=None)
def library() -> KernelLibrary:
    """The loaded kernel library, built from `csrc/` on first call."""
    nvcc = _nvcc()
    out_dir = BUILD_ROOT / _source_hash(nvcc)
    so = out_dir / "libdl4ss_kernels.so"
    t0 = time.perf_counter()
    if so.exists():
        log, seconds = (out_dir / "build.log").read_text(), 0.0
    else:
        log = _build(out_dir, nvcc)
        seconds = time.perf_counter() - t0
    dll = ctypes.CDLL(str(so))
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int}
    for name, sig in SIGNATURES.items():
        fn = getattr(dll, "dl4ss_" + name)
        fn.argtypes = [kinds[c] for c in sig] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name, sig in QUERIES.items():
        fn = getattr(dll, "dl4ss_" + name)
        fn.argtypes = [kinds[c] for c in sig]
        fn.restype = ctypes.c_longlong
    dll.dl4ss_error_string.argtypes = [ctypes.c_int]
    dll.dl4ss_error_string.restype = ctypes.c_char_p
    return KernelLibrary(dll, so, seconds, log)


def launch(name: str, device: torch.device, *args) -> None:
    """Call kernel entry point `name` on `device`'s current stream.

    Tensors pass as their data pointers, ints as C ints. Raises if the
    launch reported an error; counts the launch in LAUNCHES otherwise.
    """
    lib = library()
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else int(a)
              for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib.dll, "dl4ss_" + name)(*c_args, stream)
    if err:
        msg = lib.dll.dl4ss_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: {msg} (error {err})")
    LAUNCHES[name] += 1


@contextlib.contextmanager
def uncounted():
    """Leave every counter of COUNTERS as it was before the block. Yields a
    list that, once the block ends, holds what the block counted, a Counter
    per counter: the launches a CUDA graph's capture records, which
    `count` adds at each replay."""
    saved = [collections.Counter(c) for c in COUNTERS]
    launched: list = []
    try:
        yield launched
    finally:
        for counter, before in zip(COUNTERS, saved):
            launched.append(counter - before)
            counter.clear()
            counter.update(before)


def count(launched: list) -> None:
    """Add what `uncounted` yielded to the counters."""
    for counter, more in zip(COUNTERS, launched):
        counter.update(more)


def query(name: str, *args: int) -> int:
    """Call the plain C query `name` (see QUERIES)."""
    return int(getattr(library().dll, "dl4ss_" + name)(*map(int, args)))


def check(t: torch.Tensor, name: str, dtypes, shape=None) -> None:
    """Validate a kernel argument: CUDA, dtype, contiguity and shape."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
