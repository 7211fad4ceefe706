"""Letterbox resize + inverse box mapping.

Counterpart of caesar_yolo_tpu/detect/letterbox.py: aspect-preserving
resize with r = min(S/h, S/w) (upscaling allowed), centred padding with
gray 114/255, and the inverse mapping with the round(d -+ 0.1) pad split.
The resize is bilinear with half-pixel centres and no antialiasing
(F.interpolate align_corners=False, the reference's
jax.image.resize(method='linear', antialias=False)).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

PAD_VALUE = 114.0 / 255.0


def letterbox_geometry(h: int, w: int, img_size: int):
    """Static letterbox geometry: (scale, new_h, new_w, top, left)."""
    r = min(img_size / h, img_size / w)
    new_h, new_w = round(h * r), round(w * r)
    top = round((img_size - new_h) / 2 - 0.1)
    left = round((img_size - new_w) / 2 - 0.1)
    return r, new_h, new_w, top, left


def letterbox_nchw(x: torch.Tensor, img_size: int,
                   pad_value: float = PAD_VALUE) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, S, S] (same geometry for the whole batch)."""
    h, w = x.shape[-2:]
    _, new_h, new_w, top, left = letterbox_geometry(h, w, img_size)
    if (new_h, new_w) != (h, w):
        x = F.interpolate(x.float(), size=(new_h, new_w), mode="bilinear",
                          align_corners=False, antialias=False)
    return F.pad(x, (left, img_size - new_w - left,
                     top, img_size - new_h - top), value=pad_value)


def letterbox_batch(images: torch.Tensor, img_size: int,
                    pad_value: float = PAD_VALUE) -> torch.Tensor:
    """[B, H, W, C] -> [B, S, S, C], the reference's layout."""
    return letterbox_nchw(images.permute(0, 3, 1, 2), img_size,
                          pad_value).permute(0, 2, 3, 1)


def unletterbox_boxes(boxes: torch.Tensor, h: int, w: int,
                      img_size: int) -> torch.Tensor:
    """Map xyxy boxes from letterboxed [S, S] coords back to the original
    [h, w] image, clipped to its bounds.  The constants are filled on the
    boxes' device (no host copy: a CUDA graph may capture this)."""
    r, _, _, top, left = letterbox_geometry(h, w, img_size)
    shift = boxes.new_full((4,), left)      # [left, top, left, top]
    shift[1::2] = top
    lim = boxes.new_full((4,), w)           # [w, h, w, h]
    lim[1::2] = h
    out = (boxes - shift) / r
    return torch.minimum(out.clamp(min=0.0), lim)
