"""Small host-side utilities completing the reference's utils surface
(reference utils.py:137-149, 423-433, 700-731).

A copy of caesar_yolo_tpu/utils/misc.py (the port may not import the JAX
package).
"""

from __future__ import annotations

import functools

import numpy as np


def read_filelist(filename: str) -> list[str]:
    """Read a filelist, one path per line, whitespace stripped
    (reference utils.py:137-143 returns raw lines; stripping here saves
    every caller the rstrip)."""
    with open(filename) as fp:
        return [line.strip() for line in fp if line.strip()]


def read_table(filename: str) -> np.ndarray:
    """Read a whitespace-separated ascii table into a float array
    (reference utils.py:145-148 via astropy.io.ascii; plain numpy here).
    Lines starting with '#' are comments."""
    rows = []
    with open(filename) as fp:
        for line in fp:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append([float(v) for v in line.split()])
    return np.asarray(rows)


def apply_mask(image: np.ndarray, mask: np.ndarray, color,
               alpha: float = 0.5) -> np.ndarray:
    """Blend a binary mask into an RGB image (reference utils.py:423-433)."""
    for c in range(3):
        image[:, :, c] = np.where(
            mask == 1,
            image[:, :, c] * (1 - alpha) + alpha * color[c] * 255,
            image[:, :, c])
    return image


def to_uint8(data: np.ndarray) -> np.ndarray:
    """Normalize masked data to 0-255 uint8 (reference utils.py:700-716;
    the reference's `.as_type` typo meant it always raised — fixed)."""
    cond = (data != 0) & np.isfinite(data)
    if not cond.any():
        return np.zeros_like(data, np.uint8)
    lo = data[cond].min()
    hi = data[cond].max()
    span = hi - lo if hi > lo else 1.0
    out = (data - lo) / span * 255
    out[~cond] = 0
    return out.astype(np.uint8)


def compose_fcns(*funcs):
    """Compose functions: (f . g . h)(x) = f(g(h(x)))
    (reference utils.py:720-722)."""
    return functools.reduce(lambda f, g: lambda x: f(g(x)), funcs)


def set_type(s: str) -> str:
    """Narrow 64-bit dtype names to 32-bit (reference utils.py:724-739)."""
    if s.endswith("64") and ("float" in s or "int" in s):
        return s.replace("64", "32")
    return s
