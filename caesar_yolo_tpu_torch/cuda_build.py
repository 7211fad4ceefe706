"""Build and load the port's hand-written CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, at first use, under
``build/kernels/`` at the repository root, and loaded with ``ctypes``.
The library's file name carries a hash of its source, the headers it
includes and its flags, so an edited source is rebuilt and a stale
library is never loaded.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` turns a non-zero code into an exception.  Each wrapper counts
its launches in attributes of its function, listed in ``COUNTERS``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.normpath(
    os.path.join(os.path.dirname(CSRC), os.pardir, "build", "kernels"))

# Per-source flags.  NMS, the zscale chain, the clip statistics, the
# histogram equalisation, CLAHE, the row shift, the int8 conv and the conv
# epilogue must be bit-identical to their plain versions (clip bounds med
# +- sigma*std, bin positions (x - vmin) / span * 256, the CLAHE blend, the
# shear lerp, the int8 dequantize, the bias and SiLU), so FMA contraction
# is off there.  The upsample only
# moves data and sums in a fixed order.
SOURCES = {
    "nms": ["-fmad=false"],
    "attn": [],
    "attn_bwd": [],
    "preproc": ["-fmad=false"],
    "stats": ["-fmad=false"],
    "histeq": ["-fmad=false"],
    "upsample": [],
    "shift": ["-fmad=false"],
    "clahe": ["-fmad=false"],
    "qconv": ["-fmad=false"],
    "epilogue": ["-fmad=false"],
}
# The shared headers each source includes: their text is hashed into the
# library's name with the source's, so editing one rebuilds its includers.
HEADERS = {
    "attn": ["mma_bf16.cuh"],
    "attn_bwd": ["mma_bf16.cuh"],
    "clahe": ["async_copy.cuh", "divide.cuh"],
    "histeq": ["async_copy.cuh"],
    "preproc": ["async_copy.cuh", "divide.cuh"],
    "qconv": ["divide.cuh", "epilogue.cuh"],
    "epilogue": ["epilogue.cuh"],
    "shift": ["async_copy.cuh"],
}

# The most values a plane may hold on K3, K5 and K6.  Their stream routes
# index a plane with 64-bit ints, but K5's kept counts and K6's bin counts
# are int32, as the JAX functions' own counts are (x64 off), so a plane
# ends where int32 counting does: 2^31 - 1 values.
MAX_PLANE = 2 ** 31 - 1

# The wrappers' launch counters, (function, attribute) each, in the order
# they were made.  A wrapper bumps them in Python as it launches, so a
# CUDA graph's replay (parallel/engine.py) bumps nothing by itself.
COUNTERS: list[tuple[object, str]] = []


def counters(fn, *names: str) -> None:
    """Start the launch counters `names` of wrapper `fn` at 0 and list
    them in COUNTERS."""
    for name in names:
        setattr(fn, name, 0)
        COUNTERS.append((fn, name))


def counter_values() -> list[int]:
    """Every counter of COUNTERS, in its order."""
    return [getattr(fn, name) for fn, name in COUNTERS]


def add_to_counters(amounts) -> None:
    """Add amounts[i] to COUNTERS[i] (a shorter list leaves the rest)."""
    for (fn, name), n in zip(COUNTERS, amounts):
        if n:
            setattr(fn, name, getattr(fn, name) + n)


def plane_limit_error(kernel: str, hw: int) -> ValueError:
    """The refusal of a plane of hw > MAX_PLANE values by `kernel`."""
    return ValueError(
        f"{kernel} does not take planes of {hw} values: it counts a plane's "
        f"values in int32, as the JAX function does, so a plane holds at "
        f"most 2^31 - 1 values")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit on PATH or under /usr/local/cuda")
    return path


def _command(name: str, out: str) -> list[str]:
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            *SOURCES[name], "-o", out, os.path.join(CSRC, f"{name}.cu")]


def library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(SOURCES[name]).encode())
    for fname in [f"{name}.cu", *HEADERS.get(name, [])]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(names=None) -> dict[str, str]:
    """Compile the named sources (default: all) that are not built yet,
    one ``nvcc`` process per source, all started together.  Returns
    {name: library path}.  Raises with the compiler's output on failure."""
    names = list(SOURCES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for n in names:
        if not os.path.exists(paths[n]):
            tmp = f"{paths[n]}.{os.getpid()}.tmp"
            procs[n] = (tmp, subprocess.Popen(
                _command(n, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    errors = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {n}.cu failed ({proc.returncode}):\n{log}")
        else:
            os.replace(tmp, paths[n])
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            _libs[name] = lib
        return lib


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
