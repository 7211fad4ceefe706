"""YOLOv8 / YOLO11 / YOLO12 detector graphs as nn.Modules.

Counterpart of caesar_yolo_tpu/models/yolo.py: the same layer graphs at
scales n/s/m/l/x, with each layer registered under the reference's
params-tree name (`stem`, `c3k2_1`, `head/box/0/2`, ...).  YOLO12
(ultralytics cfg/models/12/yolo12.yaml: area attention in A2C2f stages),
which the reference lacks, takes names of the same kind (`a2c2f_1`,
`a2c2f_1/m/0/1/attn/qkv`, `a2c2f_1/gamma`).

`YOLO.forward(x[B, C, H, W])` returns per FPN level (strides 8/16/32)
the raw head maps `(box[B, 4*REG_MAX, Hl, Wl], cls[B, NC, Hl, Wl])`;
`decode_dfl` turns them into (boxes_xyxy[B, A, 4], scores[B, A, NC]),
with anchors ordered level by level and (h, w) row-major inside a level,
as the reference's `flatten_raw` / `anchor_points`.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from caesar_yolo_tpu_torch.models.layers import (
    A2C2f,
    C2PSA,
    C2f,
    C3k2,
    Concat,
    Conv,
    Conv2dRaw,
    SPPF,
    Upsample,
    make_divisible,
)
from caesar_yolo_tpu_torch.utils import portable

REG_MAX = 16  # DFL bins per box side
STRIDES = (8, 16, 32)

# (depth_mult, width_mult, max_channels)
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


def _depth(n: int, d: float) -> int:
    return max(round(n * d), 1) if n > 1 else n


class DWConv(Conv):
    """Depthwise conv block (YOLO11 detect-head cls branch); groups are
    gcd(cin, cout)."""

    def __init__(self, cin: int, cout: int, k: int = 3, s: int = 1,
                 act: bool = True):
        super().__init__(cin, cout, k, s, groups=math.gcd(cin, cout),
                         act=act)


class DetectHead(nn.Module):
    """Decoupled anchor-free detect head (v8 'legacy' / v11 DW variant):
    per level a box branch to 4*REG_MAX channels and a cls branch to NC."""

    def __init__(self, num_classes: int, chs: tuple, legacy: bool):
        super().__init__()
        self.nc = num_classes
        c2 = max(16, chs[0] // 4, REG_MAX * 4)
        c3 = max(chs[0], min(num_classes, 100))
        self.box = nn.ModuleList()
        self.cls = nn.ModuleList()
        for ch in chs:
            self.box.append(nn.ModuleList([
                Conv(ch, c2, 3), Conv(c2, c2, 3),
                Conv2dRaw(c2, 4 * REG_MAX, 1)]))
            if legacy:
                self.cls.append(nn.ModuleList([
                    Conv(ch, c3, 3), Conv(c3, c3, 3),
                    Conv2dRaw(c3, num_classes, 1)]))
            else:
                self.cls.append(nn.ModuleList([
                    DWConv(ch, ch, 3), Conv(ch, c3, 1),
                    DWConv(c3, c3, 3), Conv(c3, c3, 1),
                    Conv2dRaw(c3, num_classes, 1)]))

    def forward(self, feats):
        outs = []
        for x, box_branch, cls_branch in zip(feats, self.box, self.cls):
            b = x
            for m in box_branch:
                b = m(b)
            c = x
            for m in cls_branch:
                c = m(c)
            outs.append((b, c))
        return tuple(outs)


def _build_v8(scale: str, nc: int, in_ch: int):
    d, w, mc = V8_SCALES[scale]

    def ch(c):
        return make_divisible(min(c, mc) * w, 8)

    L = [
        (Conv(in_ch, ch(64), 3, 2), (-1,), "stem"),                   # 0
        (Conv(ch(64), ch(128), 3, 2), (-1,), "down1"),                # 1
        (C2f(ch(128), ch(128), _depth(3, d), True), (-1,), "c2f_1"),  # 2
        (Conv(ch(128), ch(256), 3, 2), (-1,), "down2"),               # 3
        (C2f(ch(256), ch(256), _depth(6, d), True), (-1,), "c2f_2"),  # 4
        (Conv(ch(256), ch(512), 3, 2), (-1,), "down3"),               # 5
        (C2f(ch(512), ch(512), _depth(6, d), True), (-1,), "c2f_3"),  # 6
        (Conv(ch(512), ch(1024), 3, 2), (-1,), "down4"),              # 7
        (C2f(ch(1024), ch(1024), _depth(3, d), True), (-1,), "c2f_4"),
        (SPPF(ch(1024), ch(1024), 5), (-1,), "sppf"),                 # 9
        (Upsample(), (-1,), "up1"),                                   # 10
        (Concat(), (-1, 6), "cat1"),                                  # 11
        (C2f(ch(1024) + ch(512), ch(512), _depth(3, d), False),
         (-1,), "neck_p4a"),                                          # 12
        (Upsample(), (-1,), "up2"),                                   # 13
        (Concat(), (-1, 4), "cat2"),                                  # 14
        (C2f(ch(512) + ch(256), ch(256), _depth(3, d), False),
         (-1,), "neck_p3"),                                           # 15
        (Conv(ch(256), ch(256), 3, 2), (-1,), "pan_down1"),           # 16
        (Concat(), (-1, 12), "cat3"),                                 # 17
        (C2f(ch(256) + ch(512), ch(512), _depth(3, d), False),
         (-1,), "neck_p4"),                                           # 18
        (Conv(ch(512), ch(512), 3, 2), (-1,), "pan_down2"),           # 19
        (Concat(), (-1, 9), "cat4"),                                  # 20
        (C2f(ch(512) + ch(1024), ch(1024), _depth(3, d), False),
         (-1,), "neck_p5"),                                           # 21
    ]
    head = DetectHead(nc, (ch(256), ch(512), ch(1024)), legacy=True)
    return L, head, (15, 18, 21)


def _build_v11(scale: str, nc: int, in_ch: int):
    d, w, mc = V11_SCALES[scale]
    c3k_all = scale in ("m", "l", "x")

    def ch(c):
        return make_divisible(min(c, mc) * w, 8)

    k2 = _depth(2, d)
    L = [
        (Conv(in_ch, ch(64), 3, 2), (-1,), "stem"),                       # 0
        (Conv(ch(64), ch(128), 3, 2), (-1,), "down1"),                    # 1
        (C3k2(ch(128), ch(256), k2, c3k=c3k_all, e=0.25), (-1,), "c3k2_1"),
        (Conv(ch(256), ch(256), 3, 2), (-1,), "down2"),                   # 3
        (C3k2(ch(256), ch(512), k2, c3k=c3k_all, e=0.25), (-1,), "c3k2_2"),
        (Conv(ch(512), ch(512), 3, 2), (-1,), "down3"),                   # 5
        (C3k2(ch(512), ch(512), k2, c3k=True), (-1,), "c3k2_3"),          # 6
        (Conv(ch(512), ch(1024), 3, 2), (-1,), "down4"),                  # 7
        (C3k2(ch(1024), ch(1024), k2, c3k=True), (-1,), "c3k2_4"),        # 8
        (SPPF(ch(1024), ch(1024), 5), (-1,), "sppf"),                     # 9
        (C2PSA(ch(1024), ch(1024), k2), (-1,), "c2psa"),                  # 10
        (Upsample(), (-1,), "up1"),                                       # 11
        (Concat(), (-1, 6), "cat1"),                                      # 12
        (C3k2(ch(1024) + ch(512), ch(512), k2, c3k=c3k_all),
         (-1,), "neck_p4a"),                                              # 13
        (Upsample(), (-1,), "up2"),                                       # 14
        (Concat(), (-1, 4), "cat2"),                                      # 15
        (C3k2(ch(512) + ch(512), ch(256), k2, c3k=c3k_all),
         (-1,), "neck_p3"),                                               # 16
        (Conv(ch(256), ch(256), 3, 2), (-1,), "pan_down1"),               # 17
        (Concat(), (-1, 13), "cat3"),                                     # 18
        (C3k2(ch(256) + ch(512), ch(512), k2, c3k=c3k_all),
         (-1,), "neck_p4"),                                               # 19
        (Conv(ch(512), ch(512), 3, 2), (-1,), "pan_down2"),               # 20
        (Concat(), (-1, 10), "cat4"),                                     # 21
        (C3k2(ch(512) + ch(1024), ch(1024), k2, c3k=True),
         (-1,), "neck_p5"),                                               # 22
    ]
    head = DetectHead(nc, (ch(256), ch(512), ch(1024)), legacy=False)
    return L, head, (16, 19, 22)


def _build_v12(scale: str, nc: int, in_ch: int):
    """yolo12.yaml as ultralytics' parse_model reads it: C3k2 takes c3k at
    scales m/l/x, and every A2C2f takes residual=True, mlp_ratio=1.2 at
    l/x (the R-ELAN layer scale; else no residual and an MLP ratio of
    2).  The stride-2 convs of layers 1 and 3 are dense: so the counts
    equal the published ones (yolo12l at 80 classes: 26,450,768
    parameters and 88.9 GFLOPs of convolutions at 640 px; groups of 2 and
    4 there would give 25,971,536 and 81.3)."""
    d, w, mc = V12_SCALES[scale]
    c3k_all = scale in ("m", "l", "x")
    a2kw = (dict(residual=True, mlp_ratio=1.2) if scale in ("l", "x")
            else {})

    def ch(c):
        return make_divisible(min(c, mc) * w, 8)

    k2, k4 = _depth(2, d), _depth(4, d)
    L = [
        (Conv(in_ch, ch(64), 3, 2), (-1,), "stem"),                       # 0
        (Conv(ch(64), ch(128), 3, 2), (-1,), "down1"),                    # 1
        (C3k2(ch(128), ch(256), k2, c3k=c3k_all, e=0.25), (-1,), "c3k2_1"),
        (Conv(ch(256), ch(256), 3, 2), (-1,), "down2"),                   # 3
        (C3k2(ch(256), ch(512), k2, c3k=c3k_all, e=0.25), (-1,), "c3k2_2"),
        (Conv(ch(512), ch(512), 3, 2), (-1,), "down3"),                   # 5
        (A2C2f(ch(512), ch(512), k4, True, 4, **a2kw), (-1,), "a2c2f_1"),
        (Conv(ch(512), ch(1024), 3, 2), (-1,), "down4"),                  # 7
        (A2C2f(ch(1024), ch(1024), k4, True, 1, **a2kw), (-1,), "a2c2f_2"),
        (Upsample(), (-1,), "up1"),                                       # 9
        (Concat(), (-1, 6), "cat1"),                                      # 10
        (A2C2f(ch(1024) + ch(512), ch(512), k2, False, -1, **a2kw),
         (-1,), "neck_p4a"),                                              # 11
        (Upsample(), (-1,), "up2"),                                       # 12
        (Concat(), (-1, 4), "cat2"),                                      # 13
        (A2C2f(ch(512) + ch(512), ch(256), k2, False, -1, **a2kw),
         (-1,), "neck_p3"),                                               # 14
        (Conv(ch(256), ch(256), 3, 2), (-1,), "pan_down1"),               # 15
        (Concat(), (-1, 11), "cat3"),                                     # 16
        (A2C2f(ch(256) + ch(512), ch(512), k2, False, -1, **a2kw),
         (-1,), "neck_p4"),                                               # 17
        (Conv(ch(512), ch(512), 3, 2), (-1,), "pan_down2"),               # 18
        (Concat(), (-1, 8), "cat4"),                                      # 19
        (C3k2(ch(512) + ch(1024), ch(1024), k2, c3k=True),
         (-1,), "neck_p5"),                                               # 20
    ]
    head = DetectHead(nc, (ch(256), ch(512), ch(1024)), legacy=False)
    return L, head, (14, 17, 20)


_BUILDERS = {"v8": _build_v8, "v11": _build_v11, "v12": _build_v12}


class YOLO(nn.Module):
    """A YOLOv8/YOLO11/YOLO12 detector as an explicit layer graph.

    version 'v8' | 'v11' | 'v12'; scale n/s/m/l/x; 5 radio-source classes
    by default.  Weights start uninitialised: load them
    (models/convert.py) or call `init_weights`.  `compute_dtype` is
    None until predictor.prepare_model or convert.build_prepared makes
    an inference model, BatchNorm folded and cast to that dtype."""

    compute_dtype: torch.dtype | None = None

    def __init__(self, version: str = "v8", scale: str = "n",
                 num_classes: int = 5, in_channels: int = 3):
        super().__init__()
        self.version, self.scale = version, scale
        self.num_classes = num_classes
        self.in_channels = in_channels
        if version not in _BUILDERS:
            raise ValueError(f"unknown version {version!r} (use "
                             f"'v8'/'v11'/'v12')")
        layers, head, self.out_idx = _BUILDERS[version](scale, num_classes,
                                                        in_channels)
        self.graph = [(name, frm) for _, frm, name in layers]
        for module, _, name in layers:
            self.add_module(name, module)
        self.head = head

    def forward_features(self, x, remat: bool = False):
        """Backbone + neck -> the 3 FPN feature maps (P3, P4, P5).

        remat=True checkpoints each layer that has parameters (the
        reference's per-layer jax.checkpoint, yolo.py:270-293): its
        internal activations are recomputed in the backward pass instead
        of kept."""
        saved = []
        prev = x
        for name, frm in self.graph:
            module = getattr(self, name)
            inputs = [prev if j == -1 else saved[j] for j in frm]
            if isinstance(module, Concat):
                prev = module(inputs)
            elif remat and any(True for _ in module.parameters()):
                prev = checkpoint(module, inputs[0], use_reentrant=False)
            else:
                prev = module(inputs[0])
            saved.append(prev)
        return tuple(saved[i] for i in self.out_idx)

    def forward(self, x, remat: bool = False):
        """Full raw forward: ((box_l, cls_l) for l in P3, P4, P5); remat
        also checkpoints the head."""
        feats = self.forward_features(x, remat=remat)
        if remat:
            return checkpoint(self.head, feats, use_reentrant=False)
        return self.head(feats)


@torch.no_grad()
def init_weights(model: YOLO, seed: int = 0) -> YOLO:
    """Seeded initialisation (in place): conv weights (and raw-conv
    biases) ~ U(+-1/sqrt(fan_in)) as torch's Conv2d default, BN at
    identity, and the detect-head bias priors of ultralytics
    (Detect.bias_init).  Numbers come from a torch.Generator and so
    differ from the reference's jax.random init of the same seed."""
    gen = torch.Generator().manual_seed(seed)

    def uniform_(t, bound):
        t.copy_(torch.rand(t.shape, generator=gen) * (2 * bound) - bound)

    for m in model.modules():
        if isinstance(m, (Conv, Conv2dRaw)):
            bound = 1.0 / math.sqrt(m.w[0].numel())
            uniform_(m.w, bound)
            if isinstance(m, Conv2dRaw):
                uniform_(m.b, bound)
    head = model.head
    for i, stride in enumerate(STRIDES):
        head.box[i][-1].b.fill_(1.0)
        head.cls[i][-1].b.fill_(
            math.log(5.0 / head.nc / (640.0 / stride) ** 2))
    return model


def anchor_points(img_size: int, device=None, strides=STRIDES,
                  offset: float = 0.5):
    """Grid-cell centres (grid units) [A, 2] and per-anchor stride [A, 1],
    concatenated over FPN levels (meshgrid 'xy' order, as the reference)."""
    pts, strs = [], []
    for s in strides:
        n = img_size // s
        xs = np.arange(n, dtype=np.float32) + offset
        xx, yy = np.meshgrid(xs, xs)
        pts.append(np.stack([xx.reshape(-1), yy.reshape(-1)], axis=-1))
        strs.append(np.full((n * n, 1), s, dtype=np.float32))
    return (torch.from_numpy(np.concatenate(pts)).to(device),
            torch.from_numpy(np.concatenate(strs)).to(device))


@functools.lru_cache(maxsize=None)
def _device_anchor_points(img_size: int, device: torch.device):
    """anchor_points on `device`, built once per size (no host->device copy
    per batch); ordinary tensors even when first asked for under
    inference_mode."""
    with torch.inference_mode(False):
        return anchor_points(img_size, device=device)


def flatten_raw(raw):
    """Per-level head maps -> (dist[B, A, 4, REG_MAX], logits[B, A, NC])
    in their native dtype, levels in stride order, (h, w) row-major."""
    dist_lvls, cls_lvls = [], []
    for box, cls in raw:
        b = box.shape[0]
        dist_lvls.append(box.permute(0, 2, 3, 1).reshape(b, -1, 4, REG_MAX))
        cls_lvls.append(cls.permute(0, 2, 3, 1).reshape(b, -1,
                                                        cls.shape[1]))
    return torch.cat(dist_lvls, dim=1), torch.cat(cls_lvls, dim=1)


def decode_dfl_window(dist, anchors, strides):
    """dist [..., 4, REG_MAX] raw logits, anchors [..., 2], strides
    [..., 1] -> xyxy boxes [..., 4] in input pixels (f32 softmax
    expectation)."""
    prob = torch.softmax(dist.float(), dim=-1)
    bins = torch.arange(REG_MAX, dtype=torch.float32, device=dist.device)
    ltrb = (prob * bins).sum(dim=-1)
    xy1 = (anchors - ltrb[..., 0:2]) * strides
    xy2 = (anchors + ltrb[..., 2:4]) * strides
    return torch.cat([xy1, xy2], dim=-1)


def decode_dfl(raw, img_size: int):
    """Raw head outputs -> (boxes_xyxy[B, A, 4], scores[B, A, NC]) f32."""
    dist, logits = flatten_raw(raw)
    # under torch.export the anchors are made in the trace (as constants):
    # a cache filled there would keep fake tensors for the live path
    anchors, strides = (
        anchor_points(img_size, device=dist.device) if portable.exporting()
        else _device_anchor_points(img_size, dist.device))
    boxes = decode_dfl_window(dist, anchors[None], strides[None])
    return boxes, torch.sigmoid(logits.float())


def build_model(name: str, num_classes: int = 5,
                in_channels: int = 3) -> YOLO:
    """Build from a reference-style name: 'yolov8n', 'yolo11l',
    'yolo12l', ..."""
    name = name.lower()
    for prefix, version in (("yolov8", "v8"), ("yolo11", "v11"),
                            ("yolov11", "v11"), ("yolo12", "v12")):
        if name.startswith(prefix):
            scale = name[len(prefix):][:1] or "n"
            if scale not in "nsmlx":
                raise ValueError(
                    f"cannot parse model name {name!r}: scale {scale!r} "
                    f"is not one of n/s/m/l/x")
            return YOLO(version, scale, num_classes, in_channels)
    raise ValueError(f"cannot parse model name {name!r}")


def count_params(model: nn.Module) -> int:
    """Number of weights, BN statistics included (the reference counts
    every leaf of its params tree)."""
    return sum(t.numel() for t in model.state_dict().values())
