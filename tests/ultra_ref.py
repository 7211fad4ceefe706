"""Torch reference-pipeline oracle (published ultralytics semantics).

Builds the COMPLETE inference pipeline the reference delegates to
ultralytics (`model(image, imgsz, conf, iou)` — reference
evaluation.py:181-193): letterbox resize, the unconditional
channel-flip + /255 input normalization, the full torch forward, DFL
decode, and ultralytics-semantics NMS (30000 pre-candidates, per-class
max_wh offsets, greedy strict-`>` suppression, max_det cap), followed
by the `scale_boxes` inverse mapping with clipping.

No real `.pt` weights exist in this environment, so golden catalogs are
generated from deterministic random-weight torch graphs built per the
published yamls; test_pipeline_parity.py asserts the JAX pipeline
reproduces those catalogs box-for-box.  The torch twins here are
re-derivations of the published architecture (as in test_torch_parity),
not ports of any repo code.

Scale coverage: parametrized v8/v11/v12 graphs covering n..x
widths (depth/width/max-channel tables per the published yamls, matching
models/yolo.py's V8_SCALES / V11_SCALES / V12_SCALES).

The YOLO12 twin (`TYolo12Scaled`: ultralytics' AAttn, ABlock and A2C2f
from ultralytics/nn/modules/block.py, the rows of
cfg/models/12/yolo12.yaml as parse_model reads them) is plain PyTorch in
float32 with no kernel, fusion or cache, and with TF32 off on the card.
Its parameters carry ultralytics' own names (`model.6.m.0.0.attn.qkv.conv.
weight`, `model.6.gamma`), so a state dict of it is what an ultralytics
checkpoint holds.  Departures from ultralytics, shared with the port:
BatchNorm eps 1e-3 (as TConv everywhere), the DFL decoded as a softmax
expectation (`ultra_decode`), and the layer scale gamma drawn at order 1
by the tests (`randomize_gamma`; ultralytics initialises it to 0.01, which
would scale the attention stages out of every comparison).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from test_torch_parity import (
    TC3,
    TC2PSA,
    TC2f,
    TC3k2,
    TConv,
    TDetect,
    TDetectV11,
    TSPPF,
    _randomize_bn,
)

V8_SCALES = {
    "n": (0.33, 0.25, 1024),
    "s": (0.33, 0.50, 1024),
    "m": (0.67, 0.75, 768),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.25, 512),
}
V11_SCALES = {
    "n": (0.50, 0.25, 1024),
    "s": (0.50, 0.50, 1024),
    "m": (0.50, 1.00, 512),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.50, 512),
}
V12_SCALES = dict(V11_SCALES)

MAX_WH = 7680.0
MAX_NMS = 30000
REG_MAX = 16
STRIDES = (8, 16, 32)


def make_div(x: float, divisor: int = 8) -> int:
    """ultralytics make_divisible (ceil)."""
    return int(math.ceil(x / divisor) * divisor)


# ---------------------------------------------------------------------------
# Scale-parametrized torch graphs (published yolov8.yaml / yolo11.yaml rows)
# ---------------------------------------------------------------------------

class TYoloV8Scaled(nn.Module):
    def __init__(self, scale: str, nc: int = 5):
        super().__init__()
        d, w, mc = V8_SCALES[scale]

        def ch(c):
            return make_div(min(c, mc) * w)

        def n(x):
            return max(round(x * d), 1)

        self.model = nn.ModuleList([
            TConv(3, ch(64), 3, 2),                            # 0
            TConv(ch(64), ch(128), 3, 2),                      # 1
            TC2f(ch(128), ch(128), n(3), True),                # 2
            TConv(ch(128), ch(256), 3, 2),                     # 3
            TC2f(ch(256), ch(256), n(6), True),                # 4
            TConv(ch(256), ch(512), 3, 2),                     # 5
            TC2f(ch(512), ch(512), n(6), True),                # 6
            TConv(ch(512), ch(1024), 3, 2),                    # 7
            TC2f(ch(1024), ch(1024), n(3), True),              # 8
            TSPPF(ch(1024), ch(1024)),                         # 9
            nn.Upsample(scale_factor=2, mode="nearest"),       # 10
            nn.Identity(),                                     # 11 concat
            TC2f(ch(1024) + ch(512), ch(512), n(3), False),    # 12
            nn.Upsample(scale_factor=2, mode="nearest"),       # 13
            nn.Identity(),                                     # 14 concat
            TC2f(ch(512) + ch(256), ch(256), n(3), False),     # 15
            TConv(ch(256), ch(256), 3, 2),                     # 16
            nn.Identity(),                                     # 17 concat
            TC2f(ch(256) + ch(512), ch(512), n(3), False),     # 18
            TConv(ch(512), ch(512), 3, 2),                     # 19
            nn.Identity(),                                     # 20 concat
            TC2f(ch(512) + ch(1024), ch(1024), n(3), False),   # 21
            TDetect(nc, (ch(256), ch(512), ch(1024))),         # 22
        ])

    def forward(self, x):
        m = self.model
        x0 = m[0](x); x1 = m[1](x0); x2 = m[2](x1); x3 = m[3](x2)
        x4 = m[4](x3); x5 = m[5](x4); x6 = m[6](x5); x7 = m[7](x6)
        x8 = m[8](x7); x9 = m[9](x8)
        y = m[12](torch.cat([m[10](x9), x6], 1))
        p3 = m[15](torch.cat([m[13](y), x4], 1))
        p4 = m[18](torch.cat([m[16](p3), y], 1))
        p5 = m[21](torch.cat([m[19](p4), x9], 1))
        return m[22]([p3, p4, p5])


class TYoloV11Scaled(nn.Module):
    def __init__(self, scale: str, nc: int = 5):
        super().__init__()
        d, w, mc = V11_SCALES[scale]
        c3k_all = scale in ("m", "l", "x")

        def ch(c):
            return make_div(min(c, mc) * w)

        k2 = max(round(2 * d), 1)
        self.model = nn.ModuleList([
            TConv(3, ch(64), 3, 2),                                   # 0
            TConv(ch(64), ch(128), 3, 2),                             # 1
            TC3k2(ch(128), ch(256), k2, c3k=c3k_all, e=0.25),         # 2
            TConv(ch(256), ch(256), 3, 2),                            # 3
            TC3k2(ch(256), ch(512), k2, c3k=c3k_all, e=0.25),         # 4
            TConv(ch(512), ch(512), 3, 2),                            # 5
            TC3k2(ch(512), ch(512), k2, c3k=True),                    # 6
            TConv(ch(512), ch(1024), 3, 2),                           # 7
            TC3k2(ch(1024), ch(1024), k2, c3k=True),                  # 8
            TSPPF(ch(1024), ch(1024)),                                # 9
            TC2PSA(ch(1024), ch(1024), k2),                           # 10
            nn.Upsample(scale_factor=2, mode="nearest"),              # 11
            nn.Identity(),                                            # 12 cat
            TC3k2(ch(1024) + ch(512), ch(512), k2, c3k=c3k_all),      # 13
            nn.Upsample(scale_factor=2, mode="nearest"),              # 14
            nn.Identity(),                                            # 15 cat
            TC3k2(ch(512) + ch(512), ch(256), k2, c3k=c3k_all),       # 16
            TConv(ch(256), ch(256), 3, 2),                            # 17
            nn.Identity(),                                            # 18 cat
            TC3k2(ch(256) + ch(512), ch(512), k2, c3k=c3k_all),       # 19
            TConv(ch(512), ch(512), 3, 2),                            # 20
            nn.Identity(),                                            # 21 cat
            TC3k2(ch(512) + ch(1024), ch(1024), k2, c3k=True),        # 22
            TDetectV11(nc, (ch(256), ch(512), ch(1024))),             # 23
        ])

    def forward(self, x):
        m = self.model
        x0 = m[0](x); x1 = m[1](x0); x2 = m[2](x1); x3 = m[3](x2)
        x4 = m[4](x3); x5 = m[5](x4); x6 = m[6](x5); x7 = m[7](x6)
        x8 = m[8](x7); x9 = m[9](x8); x10 = m[10](x9)
        y = m[13](torch.cat([m[11](x10), x6], 1))
        p3 = m[16](torch.cat([m[14](y), x4], 1))
        p4 = m[19](torch.cat([m[17](p3), y], 1))
        p5 = m[22](torch.cat([m[20](p4), x10], 1))
        return m[23]([p3, p4, p5])


class TAAttn(nn.Module):
    """ultralytics AAttn: area attention over `area` horizontal strips."""

    def __init__(self, dim, num_heads, area=1):
        super().__init__()
        self.area = area
        self.num_heads = num_heads
        self.head_dim = head_dim = dim // num_heads
        all_head_dim = head_dim * num_heads
        self.qkv = TConv(dim, all_head_dim * 3, 1, act=False)
        self.proj = TConv(all_head_dim, dim, 1, act=False)
        self.pe = TConv(all_head_dim, dim, 7, 1, g=dim, act=False)

    def forward(self, x):
        B, C, H, W = x.shape
        N = H * W
        qkv = self.qkv(x).flatten(2).transpose(1, 2)
        if self.area > 1:
            qkv = qkv.reshape(B * self.area, N // self.area, C * 3)
            B, N, _ = qkv.shape
        q, k, v = (qkv.view(B, N, self.num_heads, self.head_dim * 3)
                   .permute(0, 2, 3, 1)
                   .split([self.head_dim] * 3, dim=2))
        attn = (q.transpose(-2, -1) @ k) * (self.head_dim ** -0.5)
        attn = attn.softmax(dim=-1)
        x = v @ attn.transpose(-2, -1)
        x = x.permute(0, 3, 1, 2)
        v = v.permute(0, 3, 1, 2)
        if self.area > 1:
            x = x.reshape(B // self.area, N * self.area, C)
            v = v.reshape(B // self.area, N * self.area, C)
            B, N, _ = x.shape
        x = x.reshape(B, H, W, C).permute(0, 3, 1, 2).contiguous()
        v = v.reshape(B, H, W, C).permute(0, 3, 1, 2).contiguous()
        return self.proj(x + self.pe(v))


class TABlock(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio=1.2, area=1):
        super().__init__()
        self.attn = TAAttn(dim, num_heads, area)
        hidden = int(dim * mlp_ratio)
        self.mlp = nn.Sequential(TConv(dim, hidden, 1),
                                 TConv(hidden, dim, 1, act=False))

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.mlp(x)


class TA2C2f(nn.Module):
    """ultralytics A2C2f (R-ELAN): ABlock pairs with a2, else C3k; the
    layer-scale residual with a2 and residual."""

    def __init__(self, c1, c2, n=1, a2=True, area=1, residual=False,
                 mlp_ratio=2.0, e=0.5, g=1, shortcut=True):
        super().__init__()
        c_ = int(c2 * e)
        assert c_ % 32 == 0, "Dimension of ABlock be a multiple of 32."
        self.cv1 = TConv(c1, c_, 1, 1)
        self.cv2 = TConv((1 + n) * c_, c2, 1)
        self.gamma = (nn.Parameter(0.01 * torch.ones(c2))
                      if a2 and residual else None)
        self.m = nn.ModuleList(
            nn.Sequential(*(TABlock(c_, c_ // 32, mlp_ratio, area)
                            for _ in range(2)))
            if a2 else TC3(c_, c_, 2, shortcut, g)
            for _ in range(n))

    def forward(self, x):
        y = [self.cv1(x)]
        y.extend(m(y[-1]) for m in self.m)
        y = self.cv2(torch.cat(y, 1))
        if self.gamma is not None:
            return x + self.gamma.view(-1, len(self.gamma), 1, 1) * y
        return y


class TYolo12Scaled(nn.Module):
    def __init__(self, scale: str, nc: int = 5):
        super().__init__()
        d, w, mc = V12_SCALES[scale]
        c3k_all = scale in ("m", "l", "x")
        extra = (True, 1.2) if scale in ("l", "x") else ()

        def ch(c):
            return make_div(min(c, mc) * w)

        def n(x):
            return max(round(x * d), 1)

        self.model = nn.ModuleList([
            TConv(3, ch(64), 3, 2),                                   # 0
            TConv(ch(64), ch(128), 3, 2),                             # 1
            TC3k2(ch(128), ch(256), n(2), c3k_all, 0.25),             # 2
            TConv(ch(256), ch(256), 3, 2),                            # 3
            TC3k2(ch(256), ch(512), n(2), c3k_all, 0.25),             # 4
            TConv(ch(512), ch(512), 3, 2),                            # 5
            TA2C2f(ch(512), ch(512), n(4), True, 4, *extra),          # 6
            TConv(ch(512), ch(1024), 3, 2),                           # 7
            TA2C2f(ch(1024), ch(1024), n(4), True, 1, *extra),        # 8
            nn.Upsample(scale_factor=2, mode="nearest"),              # 9
            nn.Identity(),                                            # 10 cat
            TA2C2f(ch(1024) + ch(512), ch(512), n(2), False, -1,
                   *extra),                                           # 11
            nn.Upsample(scale_factor=2, mode="nearest"),              # 12
            nn.Identity(),                                            # 13 cat
            TA2C2f(ch(512) + ch(512), ch(256), n(2), False, -1,
                   *extra),                                           # 14
            TConv(ch(256), ch(256), 3, 2),                            # 15
            nn.Identity(),                                            # 16 cat
            TA2C2f(ch(256) + ch(512), ch(512), n(2), False, -1,
                   *extra),                                           # 17
            TConv(ch(512), ch(512), 3, 2),                            # 18
            nn.Identity(),                                            # 19 cat
            TC3k2(ch(512) + ch(1024), ch(1024), n(2), True),          # 20
            TDetectV11(nc, (ch(256), ch(512), ch(1024))),             # 21
        ])

    def forward(self, x):
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            m = self.model
            x0 = m[0](x); x1 = m[1](x0); x2 = m[2](x1); x3 = m[3](x2)
            x4 = m[4](x3); x5 = m[5](x4); x6 = m[6](x5); x7 = m[7](x6)
            x8 = m[8](x7)
            y = m[11](torch.cat([m[9](x8), x6], 1))
            p3 = m[14](torch.cat([m[12](y), x4], 1))
            p4 = m[17](torch.cat([m[15](p3), y], 1))
            p5 = m[20](torch.cat([m[18](p4), x8], 1))
            return m[21]([p3, p4, p5])
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32


def randomize_gamma(mod: nn.Module, seed: int = 0, lo: float = 0.5,
                    hi: float = 1.5) -> nn.Module:
    """Every A2C2f layer scale ~ U(lo, hi), in place."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in mod.modules():
            if isinstance(m, TA2C2f) and m.gamma is not None:
                m.gamma.copy_(lo + (hi - lo) * torch.rand(
                    m.gamma.shape, generator=g))
    return mod


def build_torch_twin(name: str, nc: int = 5, seed: int = 0,
                     calib: "torch.Tensor | None" = None):
    """Deterministic random-weight torch twin for 'yolov8n'..'yolo12x'
(YOLO12's layer scales ~ U(0.5, 1.5)).

    calib: optional model-input tensor [1, 3, S, S].  When given, the
    twin is conditioned to behave like a trained net on that input:
      1. BatchNorm running stats are set to the input's actual batch
         stats (one momentum=1.0 train-mode pass).  The reference's
         float-input path feeds values in [0, 1/255] — with random BN
         stats the activations saturate and anchor scores collapse into
         ulp-level near-ties that make the greedy-NMS order
         implementation-ambiguous; calibration keeps activations
         well-conditioned so score gaps are content-driven.
      2. The final head convs are rescaled so logits have a healthy
         spread (cls kept out of sigmoid saturation), with a falling
         DFL-bin bias ramp pulling box extents toward a few cells
         (mid-bin expectations would span the image and NMS-collapse
         dense scenes)."""
    torch.manual_seed(seed)
    if name.startswith("yolov8"):
        tm = TYoloV8Scaled(name[len("yolov8"):] or "n", nc)
    elif name.startswith("yolo11"):
        tm = TYoloV11Scaled(name[len("yolo11"):] or "n", nc)
    elif name.startswith("yolo12"):
        tm = randomize_gamma(TYolo12Scaled(name[len("yolo12"):] or "n", nc),
                             seed=seed + 3)
    else:
        raise ValueError(name)
    tm = tm.eval()
    _randomize_bn(tm, seed=seed + 1)
    if calib is None:
        return tm

    g = torch.Generator().manual_seed(seed + 2)
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.momentum = 1.0
        tm.train()
        tm(calib)
        tm.eval()

        head = tm.model[-1]
        for branch in (head.cv2, head.cv3):
            for seq in branch:
                seq[-1].bias.zero_()
        raw = tm(calib)
        for lvl, (b, c) in enumerate(raw):
            for branch, target, out in ((head.cv2, 1.5, b),
                                        (head.cv3, 0.6, c)):
                s = float(out.std())
                if s > 1e-6:
                    branch[lvl][-1].weight.mul_(target / s)
        for seq in head.cv3:
            final = seq[-1]
            final.bias.copy_(torch.empty_like(final.bias).uniform_(
                -0.5, 0.5, generator=g))
        for seq in head.cv2:
            final = seq[-1]
            jitter = torch.empty_like(final.bias).uniform_(
                -0.5, 0.5, generator=g)
            ramp = -0.6 * torch.arange(REG_MAX).repeat(4).float()
            final.bias.copy_(jitter + ramp)
    return tm


# ---------------------------------------------------------------------------
# Reference pipeline pieces (published semantics, numpy/torch)
# ---------------------------------------------------------------------------

def ultra_letterbox(img: np.ndarray, img_size: int):
    """LetterBox(auto=False, scaleup=True): bilinear resize + centered
    114-pad.  img [H, W, C] float -> (out [S, S, C], r, top, left)."""
    h, w = img.shape[:2]
    r = min(img_size / h, img_size / w)
    nh, nw = round(h * r), round(w * r)
    out_img = img.astype(np.float32)
    if (nh, nw) != (h, w):
        t = torch.from_numpy(np.ascontiguousarray(
            out_img.transpose(2, 0, 1)))[None]
        t = torch.nn.functional.interpolate(
            t, size=(nh, nw), mode="bilinear", align_corners=False)
        out_img = t[0].numpy().transpose(1, 2, 0)
    dh, dw = (img_size - nh) / 2, (img_size - nw) / 2
    top, left = int(round(dh - 0.1)), int(round(dw - 0.1))
    out = np.full((img_size, img_size, img.shape[2]), 114.0, np.float32)
    out[top:top + nh, left:left + nw] = out_img
    return out, r, top, left


def ultra_decode(raw):
    """DFL decode of per-level (box[1,64,h,w], cls[1,nc,h,w]) torch raw
    outputs -> (boxes_xyxy [A,4] numpy in letterbox pixels, scores [A,NC]).
    Grids come from the raw tensor shapes; no size parameter needed."""
    boxes_lvls, score_lvls = [], []
    for (box, cls), stride in zip(raw, STRIDES):
        b = box.detach().numpy()[0]          # [64, h, w]
        c = cls.detach().numpy()[0]          # [nc, h, w]
        _, h, w = b.shape
        dist = b.reshape(4, REG_MAX, h * w)  # side-major bins
        prob = np.exp(dist - dist.max(axis=1, keepdims=True))
        prob /= prob.sum(axis=1, keepdims=True)
        ltrb = (prob * np.arange(REG_MAX)[None, :, None]).sum(axis=1)  # [4,A]
        xs = (np.arange(w, dtype=np.float32) + 0.5)
        ys = (np.arange(h, dtype=np.float32) + 0.5)
        ax, ay = np.meshgrid(xs, ys)         # 'xy': ax varies over cols
        ax, ay = ax.reshape(-1), ay.reshape(-1)
        x1 = (ax - ltrb[0]) * stride
        y1 = (ay - ltrb[1]) * stride
        x2 = (ax + ltrb[2]) * stride
        y2 = (ay + ltrb[3]) * stride
        boxes_lvls.append(np.stack([x1, y1, x2, y2], axis=-1))
        score_lvls.append(1.0 / (1.0 + np.exp(-c.reshape(len(c), -1))).T)
    return (np.concatenate(boxes_lvls).astype(np.float32),
            np.concatenate(score_lvls).astype(np.float32))


def _iou_1_to_many(box, boxes):
    iw = np.clip(np.minimum(box[2], boxes[:, 2])
                 - np.maximum(box[0], boxes[:, 0]), 0, None)
    ih = np.clip(np.minimum(box[3], boxes[:, 3])
                 - np.maximum(box[1], boxes[:, 1]), 0, None)
    inter = iw * ih
    a1 = (box[2] - box[0]) * (box[3] - box[1])
    a2 = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / (a1 + a2 - inter)


def ultra_nms(boxes: np.ndarray, scores: np.ndarray, conf_thr: float,
              iou_thr: float, max_det: int = 300):
    """non_max_suppression, single-label path: strict conf filter,
    score-descending sort capped at 30000, per-class offsets, greedy
    strict-`>` suppression (torchvision.ops.nms), max_det cap.
    Returns (boxes [N,4], conf [N], cls [N]) score-descending."""
    conf = scores.max(axis=1)
    cls = scores.argmax(axis=1)
    m = conf > conf_thr
    boxes, conf, cls = boxes[m], conf[m], cls[m]
    order = np.argsort(-conf, kind="stable")[:MAX_NMS]
    boxes, conf, cls = boxes[order], conf[order], cls[order]
    off = boxes + (cls[:, None] * MAX_WH).astype(boxes.dtype)
    alive = np.ones(len(off), bool)
    keep = []
    for i in range(len(off)):
        if not alive[i]:
            continue
        keep.append(i)
        if len(keep) >= max_det:
            break
        if i + 1 < len(off):
            iou = _iou_1_to_many(off[i], off[i + 1:])
            alive[i + 1:] &= iou <= iou_thr
    keep = np.asarray(keep, np.int64)
    return boxes[keep], conf[keep], cls[keep]


def ultra_scale_boxes(boxes, r, top, left, h, w):
    """scale_boxes: undo letterbox, clip to the original image."""
    out = boxes.copy()
    out[:, [0, 2]] -= left
    out[:, [1, 3]] -= top
    out /= r
    out[:, [0, 2]] = out[:, [0, 2]].clip(0, w)
    out[:, [1, 3]] = out[:, [1, 3]].clip(0, h)
    return out


def ultra_pipeline(tm: nn.Module, img: np.ndarray, img_size: int,
                   conf_thr: float, iou_thr: float, max_det: int = 300):
    """The complete reference black box: float [H,W,C] image in ->
    (boxes xyxy in image coords, conf, cls) out.  Matches ultralytics
    BasePredictor.preprocess on numpy input: letterbox (114 pad) ->
    BGR->RGB flip -> /255 -> forward -> decode -> NMS -> scale_boxes."""
    h, w = img.shape[:2]
    lb, r, top, left = ultra_letterbox(img, img_size)
    x = lb[:, :, ::-1]                       # channel flip
    t = torch.from_numpy(
        np.ascontiguousarray(x.transpose(2, 0, 1)))[None] / 255.0
    with torch.no_grad():
        raw = tm(t)
    boxes, scores = ultra_decode(raw)
    b, s, c = ultra_nms(boxes, scores, conf_thr, iou_thr, max_det)
    return ultra_scale_boxes(b, r, top, left, h, w), s, c
