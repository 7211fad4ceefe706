"""Aspect-preserving resize helpers (host side, numpy).

A copy of caesar_yolo_tpu/utils/resize.py (the port may not import the
JAX package), which re-implements the reference's Mask-RCNN-style resize
utilities (reference utils.py:435-620): `resize_img_v2` with
none/square/pad64/crop modes returning (image, window, scale, padding,
crop), bilinear `resize_img` and nearest `resize_mask`.  The reference's
`resize_img` NameErrors on a missing skimage import (reference
utils.py:441); here resizing is numpy bilinear.
"""

from __future__ import annotations

import numpy as np

from caesar_yolo_tpu_torch import logger


def resize_img(image: np.ndarray, output_shape, order: int = 1,
               preserve_range: bool = True, anti_aliasing: bool = False):
    """Bilinear (order=1) or nearest (order=0) resize to output_shape.

    Half-pixel-center sampling (matches skimage/cv2 conventions).
    anti_aliasing/preserve_range kept for signature parity; values pass
    through unchanged (preserve_range semantics).
    """
    image = np.asarray(image)
    h, w = image.shape[:2]
    nh, nw = int(output_shape[0]), int(output_shape[1])
    if (nh, nw) == (h, w):
        return image.copy()
    yi = (np.arange(nh) + 0.5) * (h / nh) - 0.5
    xi = (np.arange(nw) + 0.5) * (w / nw) - 0.5
    if order == 0:
        ys = np.clip(np.round(yi).astype(int), 0, h - 1)
        xs = np.clip(np.round(xi).astype(int), 0, w - 1)
        return image[ys][:, xs]
    yi = np.clip(yi, 0, h - 1)
    xi = np.clip(xi, 0, w - 1)
    y0 = np.floor(yi).astype(int)
    x0 = np.floor(xi).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = (yi - y0).reshape(-1, 1)
    fx = (xi - x0).reshape(1, -1)
    if image.ndim == 3:
        fy = fy[..., None]
        fx = fx[..., None]
    out = (image[y0][:, x0] * (1 - fy) * (1 - fx)
           + image[y0][:, x1] * (1 - fy) * fx
           + image[y1][:, x0] * fy * (1 - fx)
           + image[y1][:, x1] * fy * fx)
    return out.astype(image.dtype) if preserve_range else out


def resize_img_v2(image: np.ndarray, min_dim=None, max_dim=None,
                  min_scale=None, mode: str = "square", order: int = 1,
                  anti_aliasing: bool = False, preserve_range: bool = True,
                  rng: np.random.Generator | None = None):
    """Resize keeping aspect ratio (reference utils.py:458-593).

    Returns (image, window(y1,x1,y2,x2), scale, padding, crop) or None on
    invalid input.  `rng` makes 'crop' mode reproducible (the reference
    uses the global random module).
    """
    image = np.asarray(image)
    image_dtype = image.dtype
    ndims = image.ndim
    h, w = image.shape[:2]
    window = (0, 0, h, w)
    scale = 1
    if ndims == 3:
        padding = [(0, 0), (0, 0), (0, 0)]
    elif ndims == 2:
        padding = [(0, 0)]
    else:
        logger.error("Unsupported image ndims (%d), returning None!", ndims)
        return None
    crop = None

    if mode == "none":
        return image, window, scale, padding, crop

    if min_dim:
        scale = max(1, min_dim / min(h, w))
    if min_scale and scale < min_scale:
        scale = min_scale
    if max_dim and mode == "square":
        image_max = max(h, w)
        if round(image_max * scale) > max_dim:
            scale = max_dim / image_max

    if scale != 1:
        image = resize_img(image, (round(h * scale), round(w * scale)),
                           order=order, preserve_range=preserve_range,
                           anti_aliasing=anti_aliasing)

    if mode == "square":
        if max_dim is None:
            logger.error("mode='square' requires max_dim, returning None!")
            return None
        h, w = image.shape[:2]
        top = (max_dim - h) // 2
        bottom = max_dim - h - top
        left = (max_dim - w) // 2
        right = max_dim - w - left
        padding = ([(top, bottom), (left, right), (0, 0)] if ndims == 3
                   else [(top, bottom), (left, right)])
        image = np.pad(image, padding, mode="constant", constant_values=0)
        window = (top, left, h + top, w + left)
    elif mode == "pad64":
        h, w = image.shape[:2]
        if min_dim and min_dim % 64 != 0:
            logger.error(
                "Minimum dimension must be a multiple of 64, returning None!")
            return None
        top = bottom = left = right = 0
        if h % 64 > 0:
            max_h = h - (h % 64) + 64
            top = (max_h - h) // 2
            bottom = max_h - h - top
        if w % 64 > 0:
            max_w = w - (w % 64) + 64
            left = (max_w - w) // 2
            right = max_w - w - left
        padding = ([(top, bottom), (left, right), (0, 0)] if ndims == 3
                   else [(top, bottom), (left, right)])
        image = np.pad(image, padding, mode="constant", constant_values=0)
        window = (top, left, h + top, w + left)
    elif mode == "crop":
        h, w = image.shape[:2]
        rng = rng or np.random.default_rng()
        y = int(rng.integers(0, h - min_dim + 1))
        x = int(rng.integers(0, w - min_dim + 1))
        crop = (y, x, min_dim, min_dim)
        image = image[y:y + min_dim, x:x + min_dim]
        window = (0, 0, min_dim, min_dim)
    else:
        logger.error("Mode %s not supported!", mode)
        return None

    return image.astype(image_dtype), window, scale, padding, crop


def resize_mask(mask: np.ndarray, scale, padding, crop=None):
    """Resize a mask with the transform from resize_img_v2
    (reference utils.py:596-620): nearest-neighbor scale + pad (+crop)."""
    mask = np.asarray(mask)
    h, w = mask.shape[:2]
    if scale != 1:
        mask = resize_img(mask, (round(h * scale), round(w * scale)),
                          order=0)
    if crop is not None:
        y, x, ch, cw = crop
        mask = mask[y:y + ch, x:x + cw]
    else:
        mask = np.pad(mask, padding[:mask.ndim], mode="constant",
                      constant_values=0)
    return mask
