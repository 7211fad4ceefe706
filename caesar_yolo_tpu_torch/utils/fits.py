"""First-party FITS image I/O (pure numpy, no astropy/fitsio dependency).

A copy of caesar_yolo_tpu/utils/fits.py: the port may not import the JAX
package, not even its host-only modules.  Header parsing and reads, full
and windowed image reads, minimal writes, the beam area, the WCS (`Wcs`:
the linear part, and the SIN/TAN/linear pixel <-> world transforms in
f64), and `read_image` for FITS, PNG and JPEG.

`read_image` returns what the reference's matplotlib reader returns.  PNG
is decoded here with the standard library's zlib and struct, so it needs
neither matplotlib nor Pillow: colour types 0, 2, 3, 4 and 6, every bit
depth the format allows, the five row filters and Adam7 interlacing; a
bad CRC, a truncated stream or anything else malformed
raises ValueError naming it.  JPEG is decoded through Pillow where it
imports, as matplotlib does, and raises ImportError naming the missing
decoder elsewhere.

Replaces the reference's astropy/fitsio usage (reference utils.py:123-418):
  - full image reads with NaN->0 and 4D->2D squeeze       (utils.py:193-246)
  - windowed tile reads WITHOUT loading the full image    (utils.py:340-418,
    there done via fitsio/cfitsio; here via a memory map of the window)
  - header-only reads / image size reads                  (utils.py:150-190)
  - degenerate 3rd/4th axis stripping                     (utils.py:250-336)
  - minimal FITS writes                                   (utils.py:126-134)

FITS data is big-endian; every read returns NATIVE float32 (float64 for
BITPIX -64 and 64-bit integers), which `torch.from_numpy` takes.
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from dataclasses import dataclass

import numpy as np

from caesar_yolo_tpu_torch import logger

FITS_BLOCK = 2880

_BITPIX_DTYPES = {
    8: np.dtype(">u1"),
    16: np.dtype(">i2"),
    32: np.dtype(">i4"),
    64: np.dtype(">i8"),
    -32: np.dtype(">f4"),
    -64: np.dtype(">f8"),
}

# Header keywords that reference axes 3/4; stripped by strip_deg_axis
# (mirrors the keyword list at reference utils.py:250-336).
_DEG_AXIS_KEYS = []
for _ax in (3, 4):
    _DEG_AXIS_KEYS += [
        f"NAXIS{_ax}", f"CTYPE{_ax}", f"CRVAL{_ax}", f"CDELT{_ax}",
        f"CRPIX{_ax}", f"CUNIT{_ax}", f"CROTA{_ax}",
    ]
    for _i in range(1, 5):
        # every matrix-key spelling Wcs.from_header accepts: PCi_j,
        # zero-padded PC0i_0j, AIPS 3-digit PC00i00j, bare PCij — and
        # the CD forms (a stripped NAXIS=2 header must not retain
        # axis-3/4 matrix elements in ANY convention)
        for _p, _sep in (("PC", "_"), ("PC", ""), ("CD", "_"), ("CD", "")):
            _DEG_AXIS_KEYS += [
                f"{_p}{_i}{_sep}{_ax}", f"{_p}{_ax}{_sep}{_i}",
            ]
        _DEG_AXIS_KEYS += [
            f"PC0{_i}_0{_ax}", f"PC0{_ax}_0{_i}",
            f"PC00{_i}00{_ax}", f"PC00{_ax}00{_i}",
            f"CD0{_i}_0{_ax}", f"CD0{_ax}_0{_i}",
        ]


class FitsHeader(dict):
    """FITS header as a dict of KEY -> value with insertion order preserved.

    COMMENT/HISTORY cards are accumulated into lists. Keys are uppercase.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.comments: list[str] = []
        self.history: list[str] = []

    def copy(self) -> "FitsHeader":
        h = FitsHeader(self)
        h.comments = list(self.comments)
        h.history = list(self.history)
        return h


def _parse_card_value(raw: str):
    """Parse the value field of a FITS header card."""
    raw = raw.strip()
    if not raw:
        return None
    if raw.startswith("'"):
        # String value: ends at closing single quote ('' escapes a quote)
        out, i = [], 1
        while i < len(raw):
            c = raw[i]
            if c == "'":
                if i + 1 < len(raw) and raw[i + 1] == "'":
                    out.append("'")
                    i += 2
                    continue
                break
            out.append(c)
            i += 1
        return "".join(out).rstrip()
    if raw == "T":
        return True
    if raw == "F":
        return False
    try:
        if any(c in raw for c in ".EeDd") and not raw.lstrip("+-").isdigit():
            return float(raw.replace("D", "E").replace("d", "e"))
        return int(raw)
    except ValueError:
        return raw


def _trim_comment(body: str) -> str:
    """Cut an inline comment (a '/' outside any quoted string)."""
    in_str = False
    j = 0
    while j < len(body):
        c = body[j]
        if c == "'":
            if in_str and j + 1 < len(body) and body[j + 1] == "'":
                j += 2
                continue
            in_str = not in_str
        elif c == "/" and not in_str:
            return body[:j]
        j += 1
    return body


def parse_header(block_iter) -> tuple[FitsHeader, int]:
    """Parse header cards from an iterator of 2880-byte blocks.

    Returns (header, nblocks_consumed).
    """
    header = FitsHeader()
    nblocks = 0
    done = False
    last_key = None  # for OGIP CONTINUE long-string concatenation
    for block in block_iter:
        nblocks += 1
        for i in range(0, FITS_BLOCK, 80):
            card = block[i:i + 80].decode("ascii", errors="replace")
            key = card[:8].strip()
            if key == "END":
                done = True
                break
            if key == "CONTINUE":
                # OGIP 1.0 long-string convention: a string value ending
                # in '&' continues on CONTINUE cards ("CONTINUE  'more'")
                prev = header.get(last_key) if last_key else None
                if isinstance(prev, str) and prev.endswith("&"):
                    cont = _parse_card_value(_trim_comment(card[8:]))
                    if isinstance(cont, str):
                        header[last_key] = prev[:-1] + cont
                continue
            if key in ("COMMENT", "HISTORY", ""):
                text = card[8:].strip()
                if key == "COMMENT":
                    header.comments.append(text)
                elif key == "HISTORY":
                    header.history.append(text)
                continue
            if card[8:10] != "= ":
                continue  # commentary-style card without value indicator
            header[key] = _parse_card_value(_trim_comment(card[10:]))
            last_key = key
        if done:
            break
    if not done:
        raise ValueError("FITS header END card not found")
    return header, nblocks


def _read_header_from_file(f) -> tuple[FitsHeader, int]:
    """Read header from an open binary file; returns (header, data_offset)."""

    def blocks():
        while True:
            b = f.read(FITS_BLOCK)
            if len(b) < FITS_BLOCK:
                raise ValueError("Truncated FITS header")
            yield b

    header, nblocks = parse_header(blocks())
    return header, nblocks * FITS_BLOCK


def get_fits_header(filename: str) -> FitsHeader | None:
    """Read the primary FITS header (reference utils.py:150-164)."""
    try:
        with open(filename, "rb") as f:
            header, _ = _read_header_from_file(f)
        return header
    except Exception as e:
        logger.error("Cannot read image file: %s (err=%s)", filename, str(e))
        return None


def get_fits_size(filename: str):
    """Return (nx, ny) from NAXIS1/NAXIS2 (reference utils.py:167-190)."""
    header = get_fits_header(filename)
    if header is None:
        return None
    if "NAXIS1" not in header:
        logger.error("NAXIS1 keyword missing in header!")
        return None
    if "NAXIS2" not in header:
        logger.error("NAXIS2 keyword missing in header!")
        return None
    return header["NAXIS1"], header["NAXIS2"]


def strip_deg_axis_from_header(header: FitsHeader) -> FitsHeader:
    """Remove 3rd/4th-axis keywords and set NAXIS=2 (ref utils.py:250-336)."""
    for key in _DEG_AXIS_KEYS:
        header.pop(key, None)
    header["NAXIS"] = 2
    return header


def _axis_info(header: FitsHeader):
    naxis = int(header.get("NAXIS", 0))
    dims = [int(header[f"NAXIS{i}"]) for i in range(1, naxis + 1)]
    bitpix = int(header["BITPIX"])
    dtype = _BITPIX_DTYPES.get(bitpix)
    if dtype is None:
        raise ValueError(f"Unsupported BITPIX {bitpix}")
    return dims, dtype


def _apply_scaling(data: np.ndarray, header: FitsHeader) -> np.ndarray:
    """Big-endian raw values -> native float (float32, or float64 for
    8-byte types) with BSCALE/BZERO applied and BLANK pixels as NaN."""
    bscale = float(header.get("BSCALE", 1.0))
    bzero = float(header.get("BZERO", 0.0))
    # BLANK marks undefined pixels in INTEGER data (FITS 4.0 §5.3); they
    # must become NaN BEFORE scaling (callers then apply the NaN->0
    # convention), not leak through as huge scaled values.  The compare
    # runs on the raw integers — after the float cast a 64-bit BLANK
    # could alias a real value.
    blank = header.get("BLANK")
    blank_mask = None
    if blank is not None and np.issubdtype(data.dtype, np.integer):
        try:
            blank_mask = data == int(blank)
        except (TypeError, ValueError):
            blank_mask = None  # malformed BLANK card: ignore, don't crash
    data = data.astype(np.float32 if data.dtype.itemsize <= 4 else np.float64)
    if bscale != 1.0 or bzero != 0.0:
        data = data * bscale + bzero
    if blank_mask is not None:
        data[blank_mask] = np.nan
    return data


def read_fits(filename: str, strip_deg_axis: bool = False):
    """Read a full FITS image; squeeze 4D->2D, NaN->0 (ref utils.py:193-246).

    Returns (data[f32/f64 2D], header, wcs) or None on failure.
    """
    try:
        with open(filename, "rb") as f:
            header, data_off = _read_header_from_file(f)
            dims, dtype = _axis_info(header)
            nchan = len(dims)
            count = int(np.prod(dims)) if dims else 0
            f.seek(data_off)
            raw = np.fromfile(f, dtype=dtype, count=count)
            if raw.size != count:
                raise ValueError(
                    f"truncated data section ({raw.size}/{count} values)")
            # FITS axis order: NAXIS1 fastest -> numpy shape reversed(dims)
            raw = raw.reshape(tuple(reversed(dims)))
    except Exception as e:
        logger.error("Cannot read image file: %s (err=%s)", filename, str(e))
        return None
    if nchan == 4:
        out = raw[0, 0, :, :]
    elif nchan == 2:
        out = raw
    else:
        logger.error(
            "Invalid/unsupported number of channels found in file %s (nchan=%d)!",
            filename, nchan)
        return None

    try:
        out = _apply_scaling(out, header)
    except Exception as e:
        # malformed BSCALE/BZERO: silently defaulting the scale would
        # return wrongly-scaled pixels — fail cleanly instead
        logger.error("Invalid BSCALE/BZERO in %s (err=%s)", filename, e)
        return None
    out[~np.isfinite(out)] = 0

    if strip_deg_axis:
        header = strip_deg_axis_from_header(header)
    return out, header, Wcs.from_header(header)


def read_fits_crop(filename: str, ixmin: int, ixmax: int, iymin: int,
                   iymax: int, strip_deg_axis: bool = False):
    """Read a window [iymin:iymax, ixmin:ixmax) without loading the image.

    Mirrors reference utils.py:340-418 (fitsio windowed read): xmax/ymax
    excluded; all-(-1|0) ranges read the full image.  The window is one
    slice of a memory map of the data section, not one read per row as in
    caesar_yolo_tpu/utils/fits.py (same values, a tenth of the host time
    for 512 px windows of a 2560 px mosaic).
    """
    read_full = all(v in (0, -1) for v in (ixmin, ixmax, iymin, iymax))
    if read_full:
        logger.warning(
            "Reading entire image as given image ranges are all <=0 "
            "(not an error if this is the user intention)...")
        return read_fits(filename, strip_deg_axis)

    if ixmin < 0 or ixmax < 0:
        logger.error("ixmin/ixmax must be >0")
        return None
    if iymin < 0 or iymax < 0:
        logger.error("iymin/iymax must be >0")
        return None
    if ixmax <= ixmin:
        logger.error("ixmax must be >ixmin!")
        return None
    if iymax <= iymin:
        logger.error("iymax must be >iymin!")
        return None

    try:
        with open(filename, "rb") as f:
            header, data_off = _read_header_from_file(f)
            dims, dtype = _axis_info(header)
            nchan = len(dims)
            if nchan == 4:
                if dims[2] != 1 or dims[3] != 1:
                    logger.error(
                        "4D FITS with non-degenerate 3rd/4th axes unsupported "
                        "in windowed read (file %s)", filename)
                    return None
                nx, ny = dims[0], dims[1]
            elif nchan == 2:
                nx, ny = dims[0], dims[1]
            else:
                logger.error(
                    "Invalid/unsupported number of channels (nchan=%d) found "
                    "in file %s!", nchan, filename)
                return None
            if ixmax > nx or iymax > ny:
                logger.error(
                    "Failed to read data in range[%d:%d,%d:%d] from file %s "
                    "(out of bounds %dx%d)!",
                    iymin, iymax, ixmin, ixmax, filename, nx, ny)
                return None
            # one copy of the window out of a read-only map of the bytes
            # from its first pixel to its last (a file truncated before
            # the last one fails to map, as a short read would)
            h, w = iymax - iymin, ixmax - ixmin
            span = np.memmap(
                f, dtype=dtype, mode="r", shape=((h - 1) * nx + w,),
                offset=data_off + (iymin * nx + ixmin) * dtype.itemsize)
            data = np.lib.stride_tricks.as_strided(
                span, shape=(h, w),
                strides=(nx * dtype.itemsize, dtype.itemsize)).copy()
            del span
    except Exception as e:
        logger.error(
            "Failed to read data in range[%d:%d,%d:%d] from file %s (err=%s)!",
            iymin, iymax, ixmin, ixmax, filename, str(e))
        return None

    try:
        data = _apply_scaling(data, header)
    except Exception as e:
        logger.error("Invalid BSCALE/BZERO in %s (err=%s)", filename, e)
        return None
    data[~np.isfinite(data)] = 0

    if strip_deg_axis:
        header = strip_deg_axis_from_header(header)
    return data, header, Wcs.from_header(header)


def _format_card(key: str, value) -> bytes:
    if isinstance(value, bool):
        v = "T" if value else "F"
        card = f"{key:<8}= {v:>20}"
    elif isinstance(value, (int, np.integer)):
        card = f"{key:<8}= {int(value):>20}"
    elif isinstance(value, (float, np.floating)):
        card = f"{key:<8}= {float(value):>20.13G}"
    elif value is None:
        card = f"{key:<8}="
    else:
        # ASCII-only per the FITS standard (replace, don't crash
        # mid-write), and truncate the VALUE so the closing quote
        # always survives the 80-char card (max 68 string chars)
        s = str(value).encode("ascii", "replace").decode("ascii")
        s = s.replace("'", "''")
        if len(s) > 68:
            s = s[:68]
            if (len(s) - len(s.rstrip("'"))) % 2 == 1:
                s = s[:-1]  # don't split an escaped quote pair
        card = f"{key:<8}= '{s:<8}'"
    return card.ljust(80)[:80].encode("ascii")


def write_fits(data: np.ndarray, filename: str, header: FitsHeader | None = None):
    """Write a minimal primary-HDU FITS image (reference utils.py:126-134)."""
    data = np.asarray(data)
    if data.dtype == np.float64:
        bitpix, dtype = -64, np.dtype(">f8")
    else:
        bitpix, dtype = -32, np.dtype(">f4")
        data = data.astype(np.float32)

    cards = [
        _format_card("SIMPLE", True),
        _format_card("BITPIX", bitpix),
        _format_card("NAXIS", data.ndim),
    ]
    for i, n in enumerate(reversed(data.shape)):
        cards.append(_format_card(f"NAXIS{i+1}", n))
    skip = {"SIMPLE", "BITPIX", "NAXIS", "EXTEND", "BSCALE", "BZERO"}
    skip |= {f"NAXIS{i}" for i in range(1, 8)}
    if header:
        for key, value in header.items():
            if key in skip:
                continue
            cards.append(_format_card(key, value))
    cards.append("END".ljust(80).encode("ascii"))
    head = b"".join(cards)
    head += b" " * (-len(head) % FITS_BLOCK)

    body = data.astype(dtype).tobytes()
    body += b"\x00" * (-len(body) % FITS_BLOCK)
    with open(filename, "wb") as f:
        f.write(head)
        f.write(body)


@dataclass
class Wcs:
    """Projection-aware celestial WCS: pixel <-> world for 2 axes.

    caesar_yolo_tpu/utils/fits.py:Wcs (the reference builds an astropy
    WCS, utils.py:233-242): reference pixel and value, axis types, the
    full 2x2 linear matrix (CDELT x PC, or CD, or CDELT with CROTA2) and
    LONPOLE.  SIN and TAN (the zenithal projections of radio continuum
    mosaics) follow the FITS-WCS convention (Calabretta & Greisen 2002):
    linear part -> projection plane -> native spherical (phi, theta) ->
    celestial by the rotation with LONPOLE (180 by default); other CTYPEs
    take the linear transform.  Pixel coordinates are 0-based; all
    arithmetic is f64.
    """

    crpix: tuple = (1.0, 1.0)
    crval: tuple = (0.0, 0.0)
    ctype: tuple = ("", "")
    # full linear matrix (CDELT x PC, or CD): intermediate = M @ dpix
    m: tuple = ((1.0, 0.0), (0.0, 1.0))
    lonpole: float = 180.0

    @classmethod
    def from_header(cls, header: FitsHeader | None):
        if header is None:
            return None
        try:
            cdelt = (float(header.get("CDELT1", 1.0)),
                     float(header.get("CDELT2", 1.0)))

            def mat(prefix, sep, default_diag):
                """2x2 from '<prefix>i<sep>j' keys, also accepting the
                zero-padded AIPS convention (PC001001 / PC01_01)."""
                out = []
                for i in (1, 2):
                    row = []
                    for j in (1, 2):
                        names = (f"{prefix}{i}{sep}{j}",
                                 f"{prefix}0{i}{sep}0{j}",
                                 f"{prefix}00{i}00{j}")
                        val = next((header[n] for n in names
                                    if n in header), None)
                        if val is None:
                            val = default_diag if i == j else 0.0
                        row.append(float(val))
                    out.append(tuple(row))
                return tuple(out)

            def has(prefix, sep):
                return any(k in header for k in
                           (f"{prefix}1{sep}1", f"{prefix}01{sep}01",
                            f"{prefix}001001"))

            if has("CD", "_"):
                # FITS-WCS (C&G 2002): once any CDi_j is present, ALL
                # absent elements default to 0 — including the diagonal
                m = mat("CD", "_", 0.0)
            elif has("PC", "_") or has("PC", ""):
                sep = "_" if has("PC", "_") else ""
                pc = mat("PC", sep, 1.0)
                m = ((cdelt[0] * pc[0][0], cdelt[0] * pc[0][1]),
                     (cdelt[1] * pc[1][0], cdelt[1] * pc[1][1]))
            elif "CROTA2" in header:
                rho = math.radians(float(header["CROTA2"]))
                m = ((cdelt[0] * math.cos(rho), -cdelt[1] * math.sin(rho)),
                     (cdelt[0] * math.sin(rho), cdelt[1] * math.cos(rho)))
            else:
                m = ((cdelt[0], 0.0), (0.0, cdelt[1]))
            return cls(
                crpix=(float(header.get("CRPIX1", 1.0)),
                       float(header.get("CRPIX2", 1.0))),
                crval=(float(header.get("CRVAL1", 0.0)),
                       float(header.get("CRVAL2", 0.0))),
                ctype=(str(header.get("CTYPE1", "")),
                       str(header.get("CTYPE2", ""))),
                m=m,
                lonpole=float(header.get("LONPOLE", 180.0)),
            )
        except Exception as e:
            logger.warning("Failed to get wcs from header (err=%s)!", str(e))
            return None

    @property
    def projection(self) -> str:
        """'SIN' / 'TAN' for supported zenithal projections, else ''."""
        t = self.ctype[0].upper()
        for proj in ("SIN", "TAN"):
            if t.endswith("-" + proj):
                return proj
        return ""

    # -- linear part ---------------------------------------------------------

    def _pixel_to_plane(self, x, y):
        dx = np.asarray(x, np.float64) + 1 - self.crpix[0]
        dy = np.asarray(y, np.float64) + 1 - self.crpix[1]
        (m11, m12), (m21, m22) = self.m
        return m11 * dx + m12 * dy, m21 * dx + m22 * dy

    def _plane_to_pixel(self, ix, iy):
        (m11, m12), (m21, m22) = self.m
        det = m11 * m22 - m12 * m21
        dx = (m22 * ix - m12 * iy) / det
        dy = (-m21 * ix + m11 * iy) / det
        return dx + self.crpix[0] - 1, dy + self.crpix[1] - 1

    # -- full transform ------------------------------------------------------

    def pixel_to_world(self, x, y):
        ix, iy = self._pixel_to_plane(x, y)
        proj = self.projection
        if not proj:
            return self.crval[0] + ix, self.crval[1] + iy
        # projection plane -> native spherical (zenithal: phi from -y axis)
        phi = np.arctan2(ix, -iy)
        r = np.hypot(ix, iy)  # degrees
        if proj == "TAN":
            theta = np.arctan2(180.0 / np.pi, r)
        else:  # SIN (orthographic)
            theta = np.arccos(np.clip(r * np.pi / 180.0, 0.0, 1.0))
        # native -> celestial (C&G 2002 eq. 2 inverse, pole at crval)
        a0 = math.radians(self.crval[0])
        d0 = math.radians(self.crval[1])
        dphi = phi - math.radians(self.lonpole)
        sin_t, cos_t = np.sin(theta), np.cos(theta)
        dec = np.arcsin(np.clip(
            sin_t * math.sin(d0) + cos_t * math.cos(d0) * np.cos(dphi),
            -1.0, 1.0))
        ra = a0 + np.arctan2(
            -cos_t * np.sin(dphi),
            sin_t * math.cos(d0) - cos_t * math.sin(d0) * np.cos(dphi))
        return np.degrees(ra) % 360.0, np.degrees(dec)

    def world_to_pixel(self, ra, dec):
        proj = self.projection
        if not proj:
            return self._plane_to_pixel(
                np.asarray(ra, np.float64) - self.crval[0],
                np.asarray(dec, np.float64) - self.crval[1])
        a = np.radians(np.asarray(ra, np.float64))
        d = np.radians(np.asarray(dec, np.float64))
        a0 = math.radians(self.crval[0])
        d0 = math.radians(self.crval[1])
        da = a - a0
        theta = np.arcsin(np.clip(
            np.sin(d) * math.sin(d0) + np.cos(d) * math.cos(d0) * np.cos(da),
            -1.0, 1.0))
        phi = math.radians(self.lonpole) + np.arctan2(
            -np.cos(d) * np.sin(da),
            np.sin(d) * math.cos(d0) - np.cos(d) * math.sin(d0) * np.cos(da))
        if proj == "TAN":
            r = (180.0 / np.pi) * np.cos(theta) / np.maximum(
                np.sin(theta), 1e-15)
        else:  # SIN
            r = (180.0 / np.pi) * np.cos(theta)
        ix = r * np.sin(phi)
        iy = -r * np.cos(phi)
        return self._plane_to_pixel(ix, iy)


def beam_area_from_header(header: FitsHeader):
    """Compute beam area in pixels (reference inference.py:430-470).

    Returns dict with dx, dy, bmaj, bmin, pa, pixel_area, beam_area; or
    None when any of CDELT1/2, BMAJ, BMIN, BPA is missing.
    """
    for key in ("CDELT1", "CDELT2", "BMAJ", "BMIN", "BPA"):
        if key not in header:
            logger.warning("%s keyword missing in header!", key)
            return None
    dx = float(header["CDELT1"])
    dy = float(header["CDELT2"])
    bmaj = float(header["BMAJ"])
    bmin = float(header["BMIN"])
    pa = float(header["BPA"])
    pixel_area = abs(dx * dy)
    a = np.pi * bmaj * bmin / (4 * np.log(2))
    return {
        "dx": dx, "dy": dy, "bmaj": bmaj, "bmin": bmin, "pa": pa,
        "pixel_area": pixel_area, "beam_area": a / pixel_area,
    }


# ---------------------------------------------------------------------------
# PNG and JPEG (read_image)
# ---------------------------------------------------------------------------

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (samples a pixel, the bit depths the format allows)
_PNG_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)),
              3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7's seven passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png_chunks(buf: bytes):
    """(type, data) of each chunk of a PNG stream up to IEND, each CRC
    checked."""
    if buf[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG stream (bad signature)")
    pos = 8
    while True:
        if pos + 12 > len(buf):
            raise ValueError("truncated PNG stream (it ends before IEND)")
        length, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        end = pos + 12 + length
        name = kind.decode("latin-1")
        if end > len(buf):
            raise ValueError(f"truncated PNG stream (inside a {name} chunk)")
        data = buf[pos + 8:end - 4]
        if zlib.crc32(kind + data) != struct.unpack(">I", buf[end - 4:end])[0]:
            raise ValueError(f"bad CRC in a PNG {name} chunk")
        yield kind, data
        if kind == b"IEND":
            return
        pos = end


def _average_or_paeth(cur: bytearray, prev: bytes, bpp: int, kind: int):
    """Undo row filter 3 (Average) or 4 (Paeth) in place: each byte
    depends on the one bpp before it, so this is a loop over bytes."""
    for i in range(bpp):  # no left neighbour: both predict the byte above
        cur[i] = (cur[i] + (prev[i] >> 1 if kind == 3 else prev[i])) & 0xFF
    for i in range(bpp, len(cur)):
        a, b = cur[i - bpp], prev[i]
        if kind == 3:
            pred = (a + b) >> 1
        else:
            c = prev[i - bpp]
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
        cur[i] = (cur[i] + pred) & 0xFF


def _unfilter(raw: bytes, pos: int, h: int, bpp: int, stride: int):
    """The h scanlines of `stride` bytes at raw[pos:], each led by its
    filter type, unfiltered -> (uint8 [h, stride], the position after)."""
    need = h * (stride + 1)
    if pos + need > len(raw):
        raise ValueError("truncated PNG image data")
    rows = np.frombuffer(raw, np.uint8, need, pos).reshape(h, stride + 1)
    out = rows[:, 1:].copy()
    prev = np.zeros(stride, np.uint8)
    for y, kind in enumerate(rows[:, 0].tolist()):
        cur = out[y]
        if kind == 1:    # Sub: a running sum along each byte lane
            cur[:] = np.cumsum(cur.reshape(-1, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur += prev
        elif kind in (3, 4):
            row = bytearray(cur.tobytes())
            _average_or_paeth(row, prev.tobytes(), bpp, kind)
            cur[:] = np.frombuffer(row, np.uint8)
        elif kind != 0:
            raise ValueError(f"unknown PNG row filter type {kind}")
        prev = cur
    return out, pos + need


def _png_samples(rows: np.ndarray, w: int, channels: int, depth: int):
    """Unfiltered scanlines uint8 [h, stride] -> samples [h, w, channels]
    (uint16 at depth 16, else uint8)."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, w, channels)
    if depth == 8:
        return rows.reshape(h, w, channels)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(h, -1)[:, :w, None]


def decode_png(buf: bytes):
    """A PNG stream -> (samples [H, W, channels] uint8 or uint16, colour
    type, bit depth, palette [N, 3] uint8 or None, tRNS bytes or None).
    Raises ValueError naming what is malformed."""
    ihdr, palette, trns, idat = None, None, None, []
    for kind, data in _png_chunks(buf):
        if kind == b"IHDR":
            ihdr = data
        elif kind == b"PLTE":
            palette = np.frombuffer(data, np.uint8)[:len(data) // 3 * 3
                                                    ].reshape(-1, 3)
        elif kind == b"tRNS":
            trns = data
        elif kind == b"IDAT":
            idat.append(data)
    if ihdr is None or len(ihdr) != 13:
        raise ValueError("PNG stream without a valid IHDR chunk")
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB",
                                                              ihdr)
    if ctype not in _PNG_TYPES or depth not in _PNG_TYPES[ctype][1]:
        raise ValueError(f"PNG colour type {ctype} at bit depth {depth} is "
                         f"not a PNG format")
    if comp != 0 or filt != 0 or interlace > 1:
        raise ValueError(f"PNG compression, filter or interlace method "
                         f"({comp}, {filt}, {interlace}) is not a PNG one")
    if w == 0 or h == 0:
        raise ValueError("PNG image of zero size")
    if ctype == 3 and palette is None:
        raise ValueError("palette PNG without a PLTE chunk")
    if not idat:
        raise ValueError("PNG stream without an IDAT chunk")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"corrupt PNG image data ({e})") from None
    channels = _PNG_TYPES[ctype][0]
    bits = channels * depth
    bpp = max(1, bits // 8)   # the filters' byte distance to the left
    if not interlace:
        rows, _ = _unfilter(raw, 0, h, bpp, (w * bits + 7) // 8)
        samples = _png_samples(rows, w, channels, depth)
    else:                     # Adam7: seven sub-images, one after another
        samples = np.zeros((h, w, channels),
                           np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
            if pw > 0 and ph > 0:
                rows, pos = _unfilter(raw, pos, ph, bpp,
                                      (pw * bits + 7) // 8)
                samples[y0::dy, x0::dx] = _png_samples(rows, pw, channels,
                                                       depth)
    return samples, ctype, depth, palette, trns


def read_png(buf: bytes) -> np.ndarray:
    """A PNG stream -> the float32 array matplotlib's imread returns for
    it (through Pillow's modes): grey [H, W] at v / (2^depth - 1), except
    that 1-bit grey is 0 or 1 and 2- and 4-bit grey is Pillow's 8-bit
    expansion divided by 3 or 15; everything else [H, W, 3 or 4] at
    v / 255, with 16-bit colour cut to its high byte and grey + alpha
    expanded to RGBA.  A palette expands to RGBA, its alpha from tRNS; a
    tRNS chunk of a grey or RGB image is ignored, as matplotlib ignores
    it."""
    samples, ctype, depth, palette, trns = decode_png(buf)
    f32 = np.float32
    if ctype == 0:
        v = samples[:, :, 0]
        top = (1 << depth) - 1
        if depth == 1:
            return v.astype(f32)
        if depth < 8:
            v = v * (255 // top)
        return np.divide(v, top, dtype=f32)
    if ctype == 3:
        idx = samples[:, :, 0]
        if int(idx.max()) >= len(palette):
            raise ValueError("PNG palette index past the end of its PLTE")
        alpha = np.full(256, 255, np.uint8)
        if trns:
            alpha[:len(trns)] = np.frombuffer(trns[:256], np.uint8)
        rgba = np.concatenate([palette[idx], alpha[idx][:, :, None]], axis=2)
        return np.divide(rgba, 255, dtype=f32)
    v = samples if depth == 8 else (samples >> 8).astype(np.uint8)
    if ctype == 4:
        v = v[:, :, [0, 0, 0, 1]]
    return np.divide(v, 255, dtype=f32)


def _read_jpeg(filename: str) -> np.ndarray:
    """uint8 [H, W] or [H, W, 3 or 4] of a JPEG, decoded by Pillow as
    matplotlib's imread decodes it (pil_to_array)."""
    try:
        from PIL import Image
    except ImportError:
        raise ImportError(
            f"{filename}: JPEG input needs Pillow (PIL), the decoder that "
            f"matplotlib reads JPEG with, and it does not import here; "
            f"convert the image to PNG or FITS") from None
    with Image.open(filename) as im:
        if im.mode not in ("RGBA", "RGBX", "RGB", "L"):
            im = im.convert("RGBA")
        return np.asarray(im)


def read_image(filename: str):
    """Read a FITS, PNG or JPEG image (reference inference.py:498-523) ->
    (data, header or None), or None for another extension.  PNG and JPEG
    give float32 in [0, 1] (matplotlib's values), alpha stripped."""
    ext = os.path.splitext(filename)[1].lower()
    if ext == ".fits":
        res = read_fits_crop(filename, -1, -1, -1, -1, strip_deg_axis=True)
        if res is None:
            return None
        data, header, _ = res
        return data, header
    if ext == ".png":
        with open(filename, "rb") as f:
            data = read_png(f.read())
    elif ext in (".jpg", ".jpeg"):
        data = _read_jpeg(filename)
    else:
        logger.error("Unsupported image format (%s) given!", ext)
        return None
    if data.ndim == 3 and data.shape[2] == 4:
        data = data[:, :, :3]
    if data.dtype == np.uint8:
        data = data.astype(np.float32) / 255.0
    return data, None
