"""Training augmentations on batches of images on the device.

Counterpart of caesar_yolo_tpu/train/augment.py: the reference's
ultralytics config degrees=180, flipud=0.5, fliplr=0.5, scale=0.89 --
random rotation and isotropic scale about the image centre with bilinear
resampling, then random flips -- with boxes taken through the same
affine and degenerate survivors dropped (w, h > 2 px, area ratio > 0.1,
aspect < 100).

Drawing is split from applying: `jax.random` and `torch.Generator` give
different numbers from one seed, so `draw_augment_params` draws with an
explicit generator and `augment_batch` applies given angles, scales and
flips (the tests feed it the reference's own draws).  Square batches take
the rot90 * x-shear * separable scale * y-shear decomposition, whose two
shear passes are kernel K8 on the card (ops/cuda_shift.py); the scales
are matrix products, as the reference left them to XLA.  Non-square
batches take the per-sample bilinear gather.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from caesar_yolo_tpu_torch.detect.letterbox import PAD_VALUE as _PAD
from caesar_yolo_tpu_torch.ops.cuda_shift import fractional_row_shift_batch


def _affine_sample(img: torch.Tensor, mat_inv: torch.Tensor,
                   pad_val: float = 0.0) -> torch.Tensor:
    """Bilinear-sample img [H, W, C] through the inverse 2x3 affine
    (output pixel -> input pixel); out-of-frame taps read pad_val."""
    h, w, _ = img.shape
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=img.device),
        torch.arange(w, dtype=torch.float32, device=img.device),
        indexing="ij")
    sx = mat_inv[0, 0] * xs + mat_inv[0, 1] * ys + mat_inv[0, 2]
    sy = mat_inv[1, 0] * xs + mat_inv[1, 1] * ys + mat_inv[1, 2]
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    x0i = x0.long()
    y0i = y0.long()

    def gather(yi, xi):
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        v = img[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        return torch.where(inb[..., None], v,
                           torch.tensor(pad_val, dtype=img.dtype,
                                        device=img.device))

    v00 = gather(y0i, x0i)
    v01 = gather(y0i, x0i + 1)
    v10 = gather(y0i + 1, x0i)
    v11 = gather(y0i + 1, x0i + 1)
    return ((v00 * (1 - fx) + v01 * fx) * (1 - fy)
            + (v10 * (1 - fx) + v11 * fx) * fy)


def _rot_scale_mats(angle, scale, cx: float, cy: float):
    """Forward (input -> output) and inverse [..., 2, 3] affines of
    rotation + scale about (cx, cy), for angle and scale tensors of one
    shape."""
    cos, sin = torch.cos(angle), torch.sin(angle)

    def compose(a, b):
        # [[a, -b], [b, a]] rotation-scale, centred (the reference adds a
        # zero translation last, which changes no value)
        row0 = torch.stack([a, -b, cx - a * cx + b * cy + 0.0], dim=-1)
        row1 = torch.stack([b, a, cy - b * cx - a * cy + 0.0], dim=-1)
        return torch.stack([row0, row1], dim=-2)

    fwd = compose(scale * cos, scale * sin)
    inv_s = 1.0 / scale
    inv = compose(inv_s * cos, -inv_s * sin)
    return fwd, inv


def _transform_boxes(boxes: torch.Tensor, mat: torch.Tensor):
    """Map xyxy boxes [..., M, 4] through [..., 2, 3] affines via their
    corners."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    xs = torch.stack([x1, x2, x1, x2], dim=-1)
    ys = torch.stack([y1, y1, y2, y2], dim=-1)
    m = mat[..., None, None, :, :]        # broadcast over boxes and corners
    tx = m[..., 0, 0] * xs + m[..., 0, 1] * ys + m[..., 0, 2]
    ty = m[..., 1, 0] * xs + m[..., 1, 1] * ys + m[..., 1, 2]
    return torch.stack([tx.amin(-1), ty.amin(-1), tx.amax(-1), ty.amax(-1)],
                       dim=-1)


def _box_candidates(orig, new, wh_thr=2.0, ar_thr=100.0, area_thr=0.1,
                    eps=1e-16):
    w1 = orig[..., 2] - orig[..., 0]
    h1 = orig[..., 3] - orig[..., 1]
    w2 = new[..., 2] - new[..., 0]
    h2 = new[..., 3] - new[..., 1]
    ar = torch.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return ((w2 > wh_thr) & (h2 > wh_thr)
            & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr))


def _scale_mats(s: torch.Tensor, size: int, center: float) -> torch.Tensor:
    """[B] scales -> [B, size, size] 1-D interpolation matrices for
    src = s * (x - c) + c (rows: output, cols: source; out-of-frame taps
    get no weight).  Built by scatter: the same values as the reference's
    one-hot sums."""
    x = torch.arange(size, dtype=torch.float32, device=s.device)
    src = s[:, None] * (x[None] - center) + center            # [B, size]
    fl = torch.floor(src)
    i0 = fl.long()
    f = src - fl
    in0 = ((i0 >= 0) & (i0 < size)).float()
    in1 = ((i0 + 1 >= 0) & (i0 + 1 < size)).float()
    out = torch.zeros(s.shape[0], size, size, dtype=torch.float32,
                      device=s.device)
    out.scatter_add_(2, i0.clamp(0, size - 1)[..., None],
                     ((1 - f) * in0)[..., None])
    out.scatter_add_(2, (i0 + 1).clamp(0, size - 1)[..., None],
                     (f * in1)[..., None])
    return out


def _rot_scale_sample_batch(imgs: torch.Tensor, angles: torch.Tensor,
                            scales: torch.Tensor,
                            pad_val: float = 0.0) -> torch.Tensor:
    """Batched bilinear resample of square imgs [B, S, S, C] through the
    centred inverse map (1/scale) R(-angle): exact rot90^q, then x-shear,
    separable scales and y-shear with |residual angle| <= 45 degrees."""
    _, h, w, _ = imgs.shape
    cx = (w - 1) / 2.0
    theta = -angles.float()
    sp = 1.0 / scales.float()
    q = torch.round(theta / (math.pi / 2)).to(torch.int32)
    r = theta - q.float() * (math.pi / 2)

    qm = (q % 4)[:, None, None, None]
    out = imgs
    for k in (1, 2, 3):
        out = torch.where(qm == k, torch.rot90(imgs, k, dims=(1, 2)), out)
    # working canvas: the intermediate passes need data the final crop
    # maps back inside (at 45 degrees the x-shear overhangs by ~S/4)
    m = int(0.35 * max(h, w)) + 2
    out = F.pad(out, (0, 0, m, m, m, m), value=pad_val)
    hp = h + 2 * m
    cp = cx + m
    pad = hp // 2 + 2
    cosr = torch.cos(r)
    u = -torch.tan(r)
    ll = torch.tan(r)
    ys = torch.arange(hp, dtype=torch.float32, device=imgs.device) - cp
    out = fractional_row_shift_batch(out, u[:, None] * ys[None], pad,
                                     pad_val)                 # x-shear
    wx = _scale_mats(sp / cosr, hp, cp)
    wy = _scale_mats(sp * cosr, hp, cp)
    out = (torch.einsum("box,bhxc->bhoc", wx, out)
           + (1.0 - wx.sum(-1))[:, None, :, None] * pad_val)
    out = (torch.einsum("boy,byxc->boxc", wy, out)
           + (1.0 - wy.sum(-1))[:, :, None, None] * pad_val)
    # y-shear: the row shift of the transposed view (the kernel reads the
    # canvas in place; the output keeps the view's strides)
    out = fractional_row_shift_batch(out.transpose(1, 2),
                                     ll[:, None] * ys[None], pad,
                                     pad_val).transpose(1, 2)
    return out[:, m:m + h, m:m + w].contiguous()


def draw_augment_params(gen: torch.Generator, bsz: int, *,
                        degrees: float = 180.0, scale: float = 0.89,
                        flipud: float = 0.5, fliplr: float = 0.5):
    """Per-sample (angles [B] radians, scales [B], do_ud [B], do_lr [B])
    on the CPU from `gen`, with the reference's distributions."""
    u = torch.rand((4, bsz), generator=gen, dtype=torch.float32)
    angles = (u[0] * (2 * degrees) - degrees) * math.pi / 180.0
    scales = u[1] * (2 * scale) + (1.0 - scale)
    return angles, scales, u[2] < flipud, u[3] < fliplr


def augment_batch(images: torch.Tensor, boxes: torch.Tensor,
                  masks: torch.Tensor, angles: torch.Tensor,
                  scales: torch.Tensor, do_ud: torch.Tensor,
                  do_lr: torch.Tensor):
    """Apply given per-sample draws: images [B, H, W, C] f32, boxes
    [B, M, 4] xyxy px, masks [B, M] -> the same shapes, on images' device.
    Square images take the shear decomposition, others the per-sample
    gather."""
    dev = images.device
    angles, scales = angles.to(dev).float(), scales.to(dev).float()
    do_ud, do_lr = do_ud.to(dev), do_lr.to(dev)
    boxes, masks = boxes.to(dev).float(), masks.to(dev).bool()
    _, h, w, _ = images.shape
    if h == w:
        imgs = _rot_scale_sample_batch(images, angles, scales, pad_val=_PAD)
    else:
        inv = _rot_scale_mats(angles, scales, (w - 1) / 2.0,
                              (h - 1) / 2.0)[1]
        imgs = torch.stack([_affine_sample(im, mi, pad_val=_PAD)
                            for im, mi in zip(images, inv)])
    # boxes transform in EDGE coordinates: centre w/2, not the
    # resampler's index-space (w-1)/2
    fwd = _rot_scale_mats(angles, scales, w / 2.0, h / 2.0)[0]
    new_boxes = _transform_boxes(boxes, fwd)
    lim = torch.tensor([w, h, w, h], dtype=new_boxes.dtype, device=dev)
    new_boxes = torch.minimum(new_boxes.clamp(min=0.0), lim)
    masks = masks & _box_candidates(boxes, new_boxes)

    imgs = torch.where(do_ud[:, None, None, None], imgs.flip(1), imgs)
    imgs = torch.where(do_lr[:, None, None, None], imgs.flip(2), imgs)
    x1, y1, x2, y2 = new_boxes.unbind(-1)
    ud, lr = do_ud[:, None], do_lr[:, None]
    x1f, x2f = torch.where(lr, w - x2, x1), torch.where(lr, w - x1, x2)
    y1f, y2f = torch.where(ud, h - y2, y1), torch.where(ud, h - y1, y2)
    return imgs, torch.stack([x1f, y1f, x2f, y2f], dim=-1), masks
