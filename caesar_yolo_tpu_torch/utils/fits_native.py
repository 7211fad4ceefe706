"""ctypes binding of the native C++ FITS tile reader (native/).

The port's own wrapper of the shared library native/libcytfits.so (the
JAX package's is caesar_yolo_tpu/utils/fits_native.py, which the port may
not import), with the same functions: `available`, `fits_info` and
`read_tiles_batch(path, windows)`, which reads many tile windows of one
file in one call on a pool of native threads (NaN -> 0, as the numpy
reader).  The library is built with `make -C native` at first use.  The
numpy reader in utils/fits.py stays the format authority and the path the
SFinder reads through; headers and WCS always come from it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from caesar_yolo_tpu_torch import logger

_LIB_NAME = "libcytfits.so"
_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "native")

_lib = None
_lib_checked = False


def _load_library(build_if_missing: bool = True):
    global _lib, _lib_checked
    if _lib_checked:
        return _lib
    _lib_checked = True
    path = os.path.join(_NATIVE_DIR, _LIB_NAME)
    if not os.path.exists(path) and build_if_missing and \
            os.path.exists(os.path.join(_NATIVE_DIR, "Makefile")):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
        except Exception as e:
            logger.info("Native FITS reader build skipped (%s); using the "
                        "pure-numpy reader", e)
            return None
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.cyt_fits_open_info.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_longlong)]
        lib.cyt_fits_open_info.restype = ctypes.c_int
        lib.cyt_fits_read_tiles.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        lib.cyt_fits_read_tiles.restype = ctypes.c_int
        lib.cyt_last_error.restype = ctypes.c_char_p
        _lib = lib
    except OSError as e:
        logger.warning("Failed to load %s (%s); using the pure-numpy "
                       "reader", path, e)
    return _lib


def available() -> bool:
    return _load_library() is not None


def fits_info(path: str):
    """(data_offset, bitpix, nx, ny) via the native parser, or None."""
    lib = _load_library()
    if lib is None:
        return None
    info = (ctypes.c_longlong * 4)()
    if lib.cyt_fits_open_info(path.encode(), info) != 0:
        logger.error("native fits_info failed: %s",
                     lib.cyt_last_error().decode())
        return None
    return tuple(int(v) for v in info)


def read_tiles_batch(path: str, windows, nthreads: int = 0):
    """Read many [x0, x1, y0, y1) windows of one FITS file at once.

    Returns a list of float32 [h, w] arrays (NaN->0 applied), or None if
    the native library is unavailable or any window fails.
    """
    lib = _load_library()
    if lib is None:
        return None
    windows = np.ascontiguousarray(np.asarray(windows, np.int64)
                                   .reshape(-1, 4))
    n = windows.shape[0]
    sizes = [(int(w[3] - w[2]), int(w[1] - w[0])) for w in windows]
    # every window must be strictly positive BEFORE calling in: the C++
    # side clamps degenerate dims to 0 when computing output offsets,
    # so a negative h*w here would under-size the buffer relative to
    # where the worker threads write (heap corruption, not just an
    # error return) — let the python fallback produce per-tile errors
    if any(h <= 0 or w <= 0 for h, w in sizes) \
            or (windows[:, [0, 2]] < 0).any():
        logger.error("native read_tiles_batch: invalid window in batch, "
                     "falling back to the python reader")
        return None
    total = sum(h * w for h, w in sizes)
    out = np.empty((total,), np.float32)
    rc = lib.cyt_fits_read_tiles(
        path.encode(),
        windows.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        int(nthreads))
    if rc != 0:
        logger.error("native read_tiles_batch failed (rc=%d): %s", rc,
                     lib.cyt_last_error().decode())
        return None
    tiles = []
    off = 0
    for h, w in sizes:
        tiles.append(out[off:off + h * w].reshape(h, w))
        off += h * w
    return tiles
