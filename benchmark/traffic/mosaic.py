"""Survey fields: Gaussian noise plus elliptical-Gaussian sources, with a
NaN-blanked border and beam keywords, written as a FITS image.

Frozen from the program's `utils/synth.make_mosaic` and
`write_mosaic_fits` (same source model, same draws in the same order from
numpy's default_rng; the noise is drawn in float32, as a whole field in
float64 would take 8 bytes a pixel), so a later change to the program
cannot change the traffic.  A traffic file names the parameters:
  field_px     side of the square field
  n_sources    sources in the field
  noise_sigma, amp_range, sigma_range   the source model
  blank_border NaN pixels along each side
"""

from __future__ import annotations

import numpy as np

FITS_BLOCK = 2880

BEAM_KEYWORDS = (("CDELT1", -2.777778e-4), ("CDELT2", 2.777778e-4),
                 ("BMAJ", 2.5e-3), ("BMIN", 2.0e-3), ("BPA", 10.0),
                 ("BUNIT", "JY/BEAM"))


def make_field(rng: np.random.Generator, field_px: int, n_sources: int,
               noise_sigma: float = 0.1, amp_range=(1.0, 10.0),
               sigma_range=(1.5, 6.0), blank_border: int = 16, **_):
    """-> image [field_px, field_px] float32 (NaN border)."""
    n = field_px
    img = rng.standard_normal((n, n), dtype=np.float32)
    img *= np.float32(noise_sigma)
    for _ in range(n_sources):
        cx = rng.uniform(10, n - 10)
        cy = rng.uniform(10, n - 10)
        sx = rng.uniform(*sigma_range)
        sy = rng.uniform(*sigma_range)
        amp = rng.uniform(*amp_range)
        x0, x1 = int(max(0, cx - 4 * sx)), int(min(n, cx + 4 * sx + 1))
        y0, y1 = int(max(0, cy - 4 * sy)), int(min(n, cy + 4 * sy + 1))
        wy = np.arange(y0, y1)[:, None]
        wx = np.arange(x0, x1)[None, :]
        img[y0:y1, x0:x1] += amp * np.exp(
            -((wx - cx) ** 2 / (2 * sx ** 2)
              + (wy - cy) ** 2 / (2 * sy ** 2))).astype(np.float32)
    b = blank_border
    if b > 0:
        img[:b] = img[-b:] = np.nan
        img[:, :b] = img[:, -b:] = np.nan
    return img


def _card(key: str, value) -> bytes:
    if isinstance(value, bool):
        card = f"{key:<8}= {'T' if value else 'F':>20}"
    elif isinstance(value, int):
        card = f"{key:<8}= {value:>20}"
    elif isinstance(value, float):
        card = f"{key:<8}= {value:>20.13G}"
    else:
        card = f"{key:<8}= '{value:<8}'"
    return card.ljust(80)[:80].encode("ascii")


def write_fits(img: np.ndarray, path: str, keywords=BEAM_KEYWORDS) -> int:
    """A primary-HDU FITS image of float32 rows (row 0 first) -> bytes
    written."""
    ny, nx = img.shape
    cards = [_card("SIMPLE", True), _card("BITPIX", -32), _card("NAXIS", 2),
             _card("NAXIS1", nx), _card("NAXIS2", ny)]
    cards += [_card(k, v) for k, v in keywords]
    head = b"".join(cards) + b"END".ljust(80)
    head += b" " * (-len(head) % FITS_BLOCK)
    body = img.astype(">f4").tobytes()
    with open(path, "wb") as f:
        f.write(head)
        f.write(body)
        f.write(b"\x00" * (-len(body) % FITS_BLOCK))
    return len(head) + len(body)
