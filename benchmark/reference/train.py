"""The plain reference of the training cell's first steps, in float32 (no
TF32) with plain PyTorch and numpy.  Imports nothing of the program.

It follows what `cli.train` does a step, from the files the benchmark
wrote and the seed alone:
  data      the loader's order (numpy's default_rng([seed, epoch]) shuffle
            of the sorted images), each FITS cutout min-maxed, its label
            rows as boxes in the letterbox frame, 1 -> 3 channels and the
            bilinear letterbox to the training size
  augment   the reference's draws (torch.Generator seeded by
            SeedSequence([seed, epoch])) of rotation, scale and flips, and
            their application: rot90, x-shear, separable scales, y-shear
            (linear interpolation, 114/255 outside), boxes through the
            same affine, degenerate boxes dropped, flips
  loss      ultralytics' v8 detection loss: task-aligned assignment (top
            10, alpha 0.5, beta 6), BCE on soft targets, CIoU and the
            distribution focal loss, gains 7.5 / 0.5 / 1.5, times the batch
  update    the gradient clipped to global norm 10, weight decay 5e-4 on
            kernels, SGD with Nesterov momentum under the published warmup
            schedules (the parameters' EMA follows the parameters and is not
            compared)
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from reference.model import REG_MAX, anchors
from reference.survey import PAD_VALUE, letterbox, letterbox_geometry

# -- data ---------------------------------------------------------------------


def epoch_order(seed: int, epoch: int, n: int) -> np.ndarray:
    order = np.arange(n)
    np.random.default_rng([seed, epoch]).shuffle(order)
    return order


def load_batch(images, lines, idx, size, max_gt, device):
    """Cutouts idx -> (imgs [B, S, S, 3] letterboxed, labels [B, M],
    boxes [B, M, 4] xyxy in the letterbox frame, mask [B, M])."""
    b = len(idx)
    h, w = images[idx[0]].shape
    r, _, _, top, left = letterbox_geometry(h, w, size)
    labels = np.zeros((b, max_gt), np.int64)
    boxes = np.zeros((b, max_gt, 4), np.float32)
    mask = np.zeros((b, max_gt), bool)
    imgs = []
    for i, k in enumerate(idx):
        img = images[k].astype(np.float32)
        lo, hi = float(img.min()), float(img.max())
        imgs.append((img - lo) / (hi - lo) if hi > lo else img * 0)
        for j, line in enumerate(lines[k][:max_gt]):
            c, cx, cy, bw, bh = (float(v) for v in line.split()[:5])
            labels[i, j] = int(c)
            boxes[i, j] = [(cx - bw / 2) * w * r + left,
                           (cy - bh / 2) * h * r + top,
                           (cx + bw / 2) * w * r + left,
                           (cy + bh / 2) * h * r + top]
            mask[i, j] = True
    x = torch.from_numpy(np.stack(imgs)).to(device)[:, None].repeat(
        1, 3, 1, 1)
    x = letterbox(x, size).permute(0, 2, 3, 1)
    return (x, torch.from_numpy(labels).to(device),
            torch.from_numpy(boxes).to(device),
            torch.from_numpy(mask).to(device))


def epoch_generator(seed: int, epoch: int) -> torch.Generator:
    state = np.random.SeedSequence([seed, epoch]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(state))


def draw_augment(gen, b, degrees, scale, flipud, fliplr):
    u = torch.rand((4, b), generator=gen, dtype=torch.float32)
    angles = (u[0] * (2 * degrees) - degrees) * math.pi / 180.0
    return angles, u[1] * (2 * scale) + (1.0 - scale), u[2] < flipud, \
        u[3] < fliplr


# -- augmentation -------------------------------------------------------------


def _row_shift(imgs, shifts, pad, pad_val):
    """out[b, y, x] = lerp of imgs[b, y, x + s] along x, s = shifts[b, y],
    the integer part clipped to [-pad, pad - 1], outside reads pad_val."""
    b, h, w, c = imgs.shape
    fl = torch.floor(shifts)
    k0, f = fl.long().clamp(-pad, pad - 1), shifts - fl
    padded = F.pad(imgs, (0, 0, pad, pad), value=pad_val)
    idx = (torch.arange(w, device=imgs.device)[None, None, :]
           + (k0 + pad)[:, :, None])[..., None].expand(b, h, w, c)
    f = f[:, :, None, None]
    return (torch.gather(padded, 2, idx) * (1 - f)
            + torch.gather(padded, 2, idx + 1) * f)


def _scale_mats(s, size, center):
    """[B, size, size] linear interpolation matrices of src = s * (x - c)
    + c (out-of-frame taps get no weight)."""
    x = torch.arange(size, dtype=torch.float32, device=s.device)
    src = s[:, None] * (x[None] - center) + center
    fl = torch.floor(src)
    i0, f = fl.long(), src - fl
    out = torch.zeros(s.shape[0], size, size, device=s.device)
    for i, wgt in ((i0, 1 - f), (i0 + 1, f)):
        inb = ((i >= 0) & (i < size)).float()
        out.scatter_add_(2, i.clamp(0, size - 1)[..., None],
                         (wgt * inb)[..., None])
    return out


def _rot_scale(imgs, angles, scales, pad_val):
    """Resample square imgs [B, S, S, C] through (1/scale) R(-angle) about
    the centre: exact rot90, then x-shear, separable scales, y-shear."""
    _, h, w, _ = imgs.shape
    cx = (w - 1) / 2.0
    theta, sp = -angles, 1.0 / scales
    q = torch.round(theta / (math.pi / 2)).to(torch.int32)
    r = theta - q.float() * (math.pi / 2)
    qm = (q % 4)[:, None, None, None]
    out = imgs
    for k in (1, 2, 3):
        out = torch.where(qm == k, torch.rot90(imgs, k, dims=(1, 2)), out)
    m = int(0.35 * max(h, w)) + 2
    out = F.pad(out, (0, 0, m, m, m, m), value=pad_val)
    hp, cp = h + 2 * m, cx + m
    pad = hp // 2 + 2
    ys = torch.arange(hp, dtype=torch.float32, device=imgs.device) - cp
    out = _row_shift(out, -torch.tan(r)[:, None] * ys[None], pad, pad_val)
    wx = _scale_mats(sp / torch.cos(r), hp, cp)
    wy = _scale_mats(sp * torch.cos(r), hp, cp)
    out = (torch.einsum("box,bhxc->bhoc", wx, out)
           + (1.0 - wx.sum(-1))[:, None, :, None] * pad_val)
    out = (torch.einsum("boy,byxc->boxc", wy, out)
           + (1.0 - wy.sum(-1))[:, :, None, None] * pad_val)
    out = _row_shift(out.transpose(1, 2).contiguous(),
                     torch.tan(r)[:, None] * ys[None], pad,
                     pad_val).transpose(1, 2)
    return out[:, m:m + h, m:m + w]


def augment(images, boxes, masks, angles, scales, do_ud, do_lr):
    dev = images.device
    angles, scales = angles.to(dev), scales.to(dev)
    do_ud, do_lr = do_ud.to(dev), do_lr.to(dev)
    _, h, w, _ = images.shape
    imgs = _rot_scale(images, angles, scales, PAD_VALUE)
    a, s = angles, scales
    cos, sin = s * torch.cos(a), s * torch.sin(a)
    cxe, cye = w / 2.0, h / 2.0
    m = torch.stack([torch.stack([cos, -sin, cxe - cos * cxe + sin * cye
                                  + 0.0], -1),
                     torch.stack([sin, cos, cye - sin * cxe - cos * cye
                                  + 0.0], -1)], -2)[:, None, None]
    x1, y1, x2, y2 = boxes.unbind(-1)
    xs = torch.stack([x1, x2, x1, x2], -1)
    ys = torch.stack([y1, y1, y2, y2], -1)
    tx = m[..., 0, 0] * xs + m[..., 0, 1] * ys + m[..., 0, 2]
    ty = m[..., 1, 0] * xs + m[..., 1, 1] * ys + m[..., 1, 2]
    new = torch.stack([tx.amin(-1), ty.amin(-1), tx.amax(-1), ty.amax(-1)],
                      -1)
    lim = torch.tensor([w, h, w, h], dtype=new.dtype, device=dev)
    new = torch.minimum(new.clamp(min=0.0), lim)
    w1, h1 = boxes[..., 2] - boxes[..., 0], boxes[..., 3] - boxes[..., 1]
    w2, h2 = new[..., 2] - new[..., 0], new[..., 3] - new[..., 1]
    ar = torch.maximum(w2 / (h2 + 1e-16), h2 / (w2 + 1e-16))
    masks = masks & (w2 > 2) & (h2 > 2) & (
        w2 * h2 / (w1 * h1 + 1e-16) > 0.1) & (ar < 100)
    imgs = torch.where(do_ud[:, None, None, None], imgs.flip(1), imgs)
    imgs = torch.where(do_lr[:, None, None, None], imgs.flip(2), imgs)
    x1, y1, x2, y2 = new.unbind(-1)
    ud, lr = do_ud[:, None], do_lr[:, None]
    return imgs, torch.stack([torch.where(lr, w - x2, x1),
                              torch.where(ud, h - y2, y1),
                              torch.where(lr, w - x1, x2),
                              torch.where(ud, h - y1, y2)], -1), masks


# -- loss ---------------------------------------------------------------------


def ciou(b1, b2, eps=1e-7):
    x11, y11, x12, y12 = b1.unbind(-1)
    x21, y21, x22, y22 = b2.unbind(-1)
    w1, h1, w2, h2 = x12 - x11, y12 - y11, x22 - x21, y22 - y21
    inter = ((torch.minimum(x12, x22) - torch.maximum(x11, x21)).clamp(min=0)
             * (torch.minimum(y12, y22) - torch.maximum(y11, y21)).clamp(
                 min=0))
    iou = inter / (w1 * h1 + w2 * h2 - inter + eps)
    cw = torch.maximum(x12, x22) - torch.minimum(x11, x21)
    ch = torch.maximum(y12, y22) - torch.minimum(y11, y21)
    rho2 = ((x21 + x22 - x11 - x12) ** 2 + (y21 + y22 - y11 - y12) ** 2) / 4
    v = (4 / math.pi ** 2) * (torch.atan(w2 / (h2 + eps))
                              - torch.atan(w1 / (h1 + eps))) ** 2
    alpha = (v / (v - iou + (1 + eps))).detach()
    return iou - (rho2 / (cw * cw + ch * ch + eps) + v * alpha)


@torch.no_grad()
def assign(scores, pboxes, pts, labels, gboxes, gmask, topk=10, alpha=0.5,
           beta=6.0, eps=1e-9):
    """Task-aligned assignment -> (target boxes [B, A, 4], target scores
    [B, A, NC], foreground [B, A])."""
    b, a, nc = scores.shape
    m = gboxes.shape[1]
    inside = torch.cat([pts[None, None] - gboxes[:, :, None, :2],
                        gboxes[:, :, None, 2:] - pts[None, None]],
                       -1).amin(-1) > eps
    overlaps = ciou(gboxes[:, :, None, :], pboxes[:, None]).clamp(min=0)
    lbl = labels.clamp(0, nc - 1)
    bscore = torch.gather(scores.transpose(1, 2), 1,
                          lbl[:, :, None].expand(b, m, a))
    align = bscore ** alpha * overlaps ** beta
    valid = inside & gmask[:, :, None]
    align_m = torch.where(valid, align, torch.zeros_like(align))
    cur, kth = align_m, None
    for _ in range(min(topk, a)):
        kth = cur.amax(-1, keepdim=True)
        cur = torch.where(cur >= kth, -math.inf, cur)
    pos = (align_m >= kth) & (align_m > eps) & valid
    counts = pos.sum(1)
    gt_idx = torch.where(counts > 1,
                         torch.where(pos, overlaps, -1.0).argmax(1),
                         pos.int().argmax(1))
    fg = counts > 0
    pos = F.one_hot(gt_idx, m).bool().transpose(1, 2) & pos
    tlabels = torch.gather(lbl, 1, gt_idx)
    tboxes = torch.gather(gboxes, 1, gt_idx[..., None].expand(b, a, 4))
    align_pos = torch.where(pos, align, 0.0)
    norm = (align_pos * torch.where(pos, overlaps, 0.0).amax(-1, True)
            / (align_pos.amax(-1, True) + eps)).amax(1)
    tscores = F.one_hot(tlabels, nc).float() * (norm * fg)[..., None]
    return tboxes, tscores, fg


def detection_loss(raw, labels, gboxes, gmask, img_size, gains=(7.5, 0.5,
                                                                1.5)):
    b = raw[0][0].shape[0]
    dist = torch.cat([x.permute(0, 2, 3, 1).reshape(b, -1, 4, REG_MAX)
                      for x, _ in raw], 1).float()
    logits = torch.cat([c.permute(0, 2, 3, 1).reshape(b, -1, c.shape[1])
                        for _, c in raw], 1).float()
    pts, strides = anchors(img_size, logits.device)
    ltrb = (torch.softmax(dist, -1)
            * torch.arange(REG_MAX, device=dist.device)).sum(-1)
    pboxes = torch.cat([pts - ltrb[..., :2], pts + ltrb[..., 2:]], -1)
    tboxes, tscores, fg = assign(torch.sigmoid(logits).detach(),
                                 pboxes.detach() * strides, pts * strides,
                                 labels, gboxes, gmask)
    tsum = tscores.sum().clamp(min=1.0)
    cls = (logits.clamp(min=0) - logits * tscores
           + torch.log1p(torch.exp(-logits.abs()))).sum() / tsum
    tb = tboxes / strides
    weight = tscores.sum(-1) * fg
    box = ((1.0 - ciou(pboxes, tb)) * weight).sum() / tsum
    td = torch.cat([pts - tb[..., :2], tb[..., 2:] - pts], -1).clamp(
        0, REG_MAX - 1 - 0.01)
    tl = torch.floor(td).long()
    wl = (tl + 1).float() - td
    logp = torch.log_softmax(dist, -1)
    dfl = -(logp * (wl[..., None] * F.one_hot(tl, REG_MAX)
                    + (1 - wl)[..., None] * F.one_hot(tl + 1, REG_MAX))
            ).sum(-1).mean(-1)
    dfl = (dfl * weight).sum() / tsum
    return (gains[0] * box + gains[1] * cls + gains[2] * dfl) * b


# -- update -------------------------------------------------------------------


class SGD:
    """The update of the published recipe (ultralytics' defaults as the
    reference package trains): lr and momentum warm up linearly over the
    first warmup_epochs, then lr decays linearly to lr0 * lrf."""

    def __init__(self, params: dict, steps_per_epoch: int, epochs: int,
                 lr0=0.01, lrf=0.01, momentum=0.937, warmup_momentum=0.8,
                 warmup_epochs=3.0, weight_decay=5e-4, clip=10.0):
        self.p = params
        self.trace = {k: torch.zeros_like(v) for k, v in params.items()}
        self.total = max(epochs * steps_per_epoch, 1)
        self.warm = max(int(warmup_epochs * steps_per_epoch), 1)
        self.lr0, self.lrf, self.mom = lr0, lrf, momentum
        self.wmom, self.wd, self.clip = warmup_momentum, weight_decay, clip
        self.step = 0

    def lr(self, s):
        if s < self.warm:
            return self.lr0 * min(s / self.warm, 1.0)
        frac = min(s / self.total, 1.0)
        return self.lr0 * ((1 - frac) * (1 - self.lrf) + self.lrf)

    def momentum(self, s):
        return self.wmom + (self.mom - self.wmom) * min(s / self.warm, 1.0)

    @torch.no_grad()
    def apply(self, grads: dict):
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in
                              grads.values())).float()
        factor = min(1.0, self.clip / float(norm))
        lr, mom = self.lr(self.step), self.momentum(self.step)
        for k, p in self.p.items():
            g = grads[k] * factor
            if k.rsplit(".", 1)[-1] == "w":
                g = g + self.wd * p
            self.trace[k] = g + mom * self.trace[k]
            p -= lr * (g + mom * self.trace[k])
        self.step += 1


def follow(model, batches, img_size, steps_per_epoch, epochs):
    """The reference's first len(batches) steps from the model's weights:
    -> {"loss": [...], "grad1": {leaf: the first step's update direction
    before momentum, as the optimizer holds it}, "delta": {leaf: change
    of the parameters}}."""
    params = dict(model.named_parameters())
    start = {k: v.detach().clone() for k, v in params.items()}
    opt = SGD(params, steps_per_epoch, epochs)
    out = {"loss": []}
    model.train()
    for i, (x, labels, boxes, mask) in enumerate(batches):
        for p in params.values():
            p.grad = None
        loss = detection_loss(model(x.permute(0, 3, 1, 2)), labels, boxes,
                              mask, img_size)
        loss.backward()
        out["loss"].append(float(loss))
        opt.apply({k: p.grad for k, p in params.items()})
        if i == 0:
            out["grad1"] = {k: t.clone() for k, t in opt.trace.items()}
    out["delta"] = {k: params[k].detach() - start[k] for k in params}
    return out
