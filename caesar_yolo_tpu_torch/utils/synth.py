"""Synthetic radio mosaics (testing and benchmarking): Gaussian noise plus
elliptical-Gaussian sources with their ground-truth boxes, in memory or
as a FITS file.  A copy of caesar_yolo_tpu/utils/synth.py, drawing the
same numbers from the same seed, plus `write_labelled_cutouts`, a
labelled cutout set in the ultralytics layout."""

from __future__ import annotations

import os

import numpy as np

from caesar_yolo_tpu_torch.utils.fits import FitsHeader, write_fits


def make_mosaic(nx: int = 1024, ny: int = 1024, n_sources: int = 40,
                noise_sigma: float = 0.1, seed: int = 0,
                amp_range=(1.0, 10.0), sigma_range=(1.5, 6.0)):
    """-> (image[ny, nx] float32, gt_boxes[N, 4] xyxy float32).

    Each gt box is the source's 2-sigma extent."""
    rng = np.random.default_rng(seed)
    img = rng.normal(0.0, noise_sigma, (ny, nx)).astype(np.float32)
    boxes = []
    for _ in range(n_sources):
        cx = rng.uniform(10, nx - 10)
        cy = rng.uniform(10, ny - 10)
        sx = rng.uniform(*sigma_range)
        sy = rng.uniform(*sigma_range)
        amp = rng.uniform(*amp_range)
        # add within a local window only
        x0, x1 = int(max(0, cx - 4 * sx)), int(min(nx, cx + 4 * sx + 1))
        y0, y1 = int(max(0, cy - 4 * sy)), int(min(ny, cy + 4 * sy + 1))
        wy = np.arange(y0, y1)[:, None]
        wx = np.arange(x0, x1)[None, :]
        img[y0:y1, x0:x1] += amp * np.exp(
            -((wx - cx) ** 2 / (2 * sx ** 2)
              + (wy - cy) ** 2 / (2 * sy ** 2))).astype(np.float32)
        boxes.append([cx - 2 * sx, cy - 2 * sy, cx + 2 * sx, cy + 2 * sy])
    return img, np.asarray(boxes, np.float32).reshape(-1, 4)


def write_mosaic_fits(path: str, nx: int = 1024, ny: int = 1024,
                      blank_border: int = 0, **kwargs):
    """Write a synthetic mosaic FITS with beam keywords; returns gt boxes.

    `blank_border` > 0 sets that many pixels along each side to NaN, as
    survey mosaics blank their edges (the reader turns them into 0); 0
    writes the same file as the reference's write_mosaic_fits."""
    img, boxes = make_mosaic(nx=nx, ny=ny, **kwargs)
    if blank_border > 0:
        b = blank_border
        img[:b] = img[-b:] = np.nan
        img[:, :b] = img[:, -b:] = np.nan
    header = FitsHeader()
    header["CDELT1"] = -2.777778e-4
    header["CDELT2"] = 2.777778e-4
    header["BMAJ"] = 2.5e-3
    header["BMIN"] = 2.0e-3
    header["BPA"] = 10.0
    header["BUNIT"] = "JY/BEAM"
    write_fits(img, path, header)
    return boxes


def write_labelled_cutouts(root: str, n: int, sizes=(132,), seed: int = 0,
                           label: int | None = None,
                           **mosaic_kwargs) -> list[str]:
    """n FITS cutouts with 1-3 Gaussian sources each under root/images and
    their YOLO label files (class cx cy w h, normalised, the 2-sigma boxes
    clipped to the cutout) under root/labels.  Cutout i has size
    sizes[i % len(sizes)], seed `seed + i`, and its j-th source the class
    `label`, or (i + j) % 5 when label is None.  make_mosaic's keywords
    default to noise 0.1, amplitudes 2-10 and widths 2-5 px.  Returns the
    image paths."""
    kw = dict(noise_sigma=0.1, amp_range=(2.0, 10.0),
              sigma_range=(2.0, 5.0))
    kw.update(mosaic_kwargs)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "labels"), exist_ok=True)
    paths = []
    for i in range(n):
        s = sizes[i % len(sizes)]
        img, boxes = make_mosaic(s, s, n_sources=1 + i % 3, seed=seed + i,
                                 **kw)
        path = os.path.join(root, "images", f"c{i:03d}.fits")
        write_fits(img, path)
        rows = []
        for j, (x1, y1, x2, y2) in enumerate(np.clip(boxes, 0, s)):
            cls = (i + j) % 5 if label is None else label
            rows.append(f"{cls} {(x1 + x2) / 2 / s:.6f} "
                        f"{(y1 + y2) / 2 / s:.6f} {(x2 - x1) / s:.6f} "
                        f"{(y2 - y1) / s:.6f}")
        with open(os.path.join(root, "labels", f"c{i:03d}.txt"), "w") as f:
            f.write("\n".join(rows) + "\n")
        paths.append(path)
    return paths
