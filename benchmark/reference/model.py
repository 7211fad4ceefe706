"""Plain PyTorch YOLOv8 and YOLO11 detectors: the benchmark's reference model.

Written from the published architectures (ultralytics
cfg/models/v8/yolov8.yaml and cfg/models/11/yolo11.yaml, scales n/s/m/l/x)
in float32 with no kernels, no fusion and no caching.  Parameters carry the
names of the npz weight format that `cli.run --weights` reads ('/'-joined
paths such as `c3k2_1/m/0/cv1/w`, `head/box/0/2/b`), so one weight file
serves the program and this model.  Imports nothing of the program.

Departures from ultralytics, all shared with the program's npz format:
BatchNorm eps 1e-3, the DFL decoded as a softmax expectation, C2PSA heads
of 64 channels.  `Conv.quant` is a hook for the lower-precision control: a
function applied to each conv's input and weight before the product.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3
REG_MAX = 16
STRIDES = (8, 16, 32)


def make_divisible(x: float, divisor: int = 8) -> int:
    return max(divisor, int(x + divisor / 2) // divisor * divisor)


def _depth(n: int, d: float) -> int:
    return max(round(n * d), 1) if n > 1 else n


class BatchNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(c))
        self.beta = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))


class Conv(nn.Module):
    """conv -> BatchNorm -> SiLU.  In training, BatchNorm normalises with
    the batch's mean and biased variance over N, H, W."""

    quant = None      # set on the class by the lower-precision control
    record = None     # a dict: training forwards store {Conv: (mean, var)}

    def __init__(self, cin, cout, k=1, s=1, groups=1, act=True):
        super().__init__()
        self.s, self.pad, self.groups, self.act = s, k // 2, groups, act
        self.w = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.bn = BatchNorm(cout)

    def forward(self, x):
        q = Conv.quant
        w = self.w if q is None else q(self.w)
        y = F.conv2d(x if q is None else q(x), w, None, self.s, self.pad, 1,
                     self.groups)
        if self.training:
            var, mean = torch.var_mean(y, dim=(0, 2, 3), correction=0)
            if Conv.record is not None:
                Conv.record[self] = (mean.detach(), var.detach())
        else:
            mean, var = self.bn.mean, self.bn.var
        scale = self.bn.gamma / torch.sqrt(var + BN_EPS)
        y = y * scale[:, None, None] + (self.bn.beta - mean * scale)[:, None,
                                                                     None]
        return F.silu(y) if self.act else y


class Conv2dRaw(nn.Module):
    """Bare conv with bias (the detect head's last 1x1 convs)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.w = nn.Parameter(torch.empty(cout, cin, 1, 1))
        self.b = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        q = Conv.quant
        w = self.w if q is None else q(self.w)
        return F.conv2d(x if q is None else q(x), w, self.b)


class Bottleneck(nn.Module):
    def __init__(self, cin, cout, shortcut=True, k=(3, 3), e=1.0):
        super().__init__()
        c_ = int(cout * e)
        self.cv1 = Conv(cin, c_, k[0])
        self.cv2 = Conv(c_, cout, k[1])
        self.add = shortcut and cin == cout

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    def __init__(self, cin, cout, n=1, shortcut=False, e=0.5):
        super().__init__()
        self.c = int(cout * e)
        self.cv1 = Conv(cin, 2 * self.c)
        self.cv2 = Conv((2 + n) * self.c, cout)
        self.m = nn.ModuleList(Bottleneck(self.c, self.c, shortcut)
                               for _ in range(n))

    def forward(self, x):
        y = self.cv1(x)
        parts = [y[:, :self.c], y[:, self.c:]]
        for block in self.m:
            parts.append(block(parts[-1]))
        return self.cv2(torch.cat(parts, 1))


class C3(nn.Module):
    def __init__(self, cin, cout, n=1, shortcut=True, e=0.5, k=3):
        super().__init__()
        c_ = int(cout * e)
        self.cv1 = Conv(cin, c_)
        self.cv2 = Conv(cin, c_)
        self.cv3 = Conv(2 * c_, cout)
        self.m = nn.ModuleList(Bottleneck(c_, c_, shortcut, (k, k))
                               for _ in range(n))

    def forward(self, x):
        y = self.cv1(x)
        for block in self.m:
            y = block(y)
        return self.cv3(torch.cat([y, self.cv2(x)], 1))


class C3k2(C2f):
    def __init__(self, cin, cout, n=1, c3k=False, e=0.5):
        super().__init__(cin, cout, n, True, e)
        self.m = nn.ModuleList(
            C3(self.c, self.c, 2, True) if c3k
            else Bottleneck(self.c, self.c, True, e=0.5) for _ in range(n))


class SPPF(nn.Module):
    def __init__(self, cin, cout, k=5):
        super().__init__()
        self.k = k
        self.cv1 = Conv(cin, cin // 2)
        self.cv2 = Conv(cin // 2 * 4, cout)

    def forward(self, x):
        ys = [self.cv1(x)]
        for _ in range(3):
            ys.append(F.max_pool2d(ys[-1], self.k, 1, self.k // 2))
        return self.cv2(torch.cat(ys, 1))


class Attention(nn.Module):
    def __init__(self, dim, num_heads):
        super().__init__()
        self.heads = num_heads
        self.hd = dim // num_heads
        self.kd = self.hd // 2
        self.dim = dim
        self.qkv = Conv(dim, dim + 2 * self.kd * num_heads, act=False)
        self.proj = Conv(dim, dim, act=False)
        self.pe = Conv(dim, dim, 3, groups=dim, act=False)

    def forward(self, x):
        b, _, h, w = x.shape
        kd, hd = self.kd, self.hd
        qkv = self.qkv(x).reshape(b, self.heads, 2 * kd + hd, h * w)
        q, k, v = qkv[:, :, :kd], qkv[:, :, kd:2 * kd], qkv[:, :, 2 * kd:]
        att = torch.softmax((q.transpose(2, 3) @ k) * kd ** -0.5, dim=-1)
        out = (v @ att.transpose(2, 3)).reshape(b, self.dim, h, w)
        return self.proj(out + self.pe(v.reshape(b, self.dim, h, w)))


class PSABlock(nn.Module):
    def __init__(self, c, num_heads):
        super().__init__()
        self.attn = Attention(c, num_heads)
        self.ffn1 = Conv(c, 2 * c)
        self.ffn2 = Conv(2 * c, c, act=False)

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.ffn2(self.ffn1(x))


class C2PSA(nn.Module):
    def __init__(self, c, n=1):
        super().__init__()
        self.c = c // 2
        self.cv1 = Conv(c, c)
        self.cv2 = Conv(c, c)
        self.m = nn.ModuleList(PSABlock(self.c, max(1, self.c // 64))
                               for _ in range(n))

    def forward(self, x):
        y = self.cv1(x)
        a, b = y[:, :self.c], y[:, self.c:]
        for block in self.m:
            b = block(b)
        return self.cv2(torch.cat([a, b], 1))


class Upsample(nn.Module):
    def forward(self, x):
        return x.repeat_interleave(2, 2).repeat_interleave(2, 3)


class Concat(nn.Module):
    def forward(self, xs):
        return torch.cat(xs, 1)


class DetectHead(nn.Module):
    """Per level a box branch to 4 * REG_MAX channels and a class branch
    (v8: two 3x3 convs; v11: depthwise 3x3 and 1x1, twice)."""

    def __init__(self, nc, chs, legacy):
        super().__init__()
        c2 = max(16, chs[0] // 4, REG_MAX * 4)
        c3 = max(chs[0], min(nc, 100))
        self.box, self.cls = nn.ModuleList(), nn.ModuleList()
        for ch in chs:
            self.box.append(nn.ModuleList([Conv(ch, c2, 3), Conv(c2, c2, 3),
                                           Conv2dRaw(c2, 4 * REG_MAX)]))
            self.cls.append(nn.ModuleList(
                [Conv(ch, c3, 3), Conv(c3, c3, 3), Conv2dRaw(c3, nc)]
                if legacy else
                [Conv(ch, ch, 3, groups=math.gcd(ch, ch)), Conv(ch, c3, 1),
                 Conv(c3, c3, 3, groups=c3), Conv(c3, c3, 1),
                 Conv2dRaw(c3, nc)]))

    def forward(self, feats):
        outs = []
        for x, box, cls in zip(feats, self.box, self.cls):
            b, c = x, x
            for m in box:
                b = m(b)
            for m in cls:
                c = m(c)
            outs.append((b, c))
        return outs


SCALES = {"v8": {"n": (0.33, 0.25, 1024), "s": (0.33, 0.50, 1024),
                 "m": (0.67, 0.75, 768), "l": (1.00, 1.00, 512),
                 "x": (1.00, 1.25, 512)},
          "v11": {"n": (0.50, 0.25, 1024), "s": (0.50, 0.50, 1024),
                  "m": (0.50, 1.00, 512), "l": (1.00, 1.00, 512),
                  "x": (1.00, 1.50, 512)}}


def parse_name(name: str):
    """'yolov8l' -> ('v8', 'l'); 'yolo11n' -> ('v11', 'n')."""
    for prefix, version in (("yolov8", "v8"), ("yolo11", "v11")):
        if name.startswith(prefix) and name[len(prefix):] in "nsmlx":
            return version, name[len(prefix):]
    raise ValueError(f"unknown model {name!r}")


def _layers(version, d, w, mc, in_ch):
    def ch(c):
        return make_divisible(min(c, mc) * w, 8)

    if version == "v8":
        def blk(cin, cout, n, shortcut):
            return C2f(cin, cout, _depth(n, d), shortcut)
        rows = [
            ("stem", Conv(in_ch, ch(64), 3, 2), (-1,)),
            ("down1", Conv(ch(64), ch(128), 3, 2), (-1,)),
            ("c2f_1", blk(ch(128), ch(128), 3, True), (-1,)),
            ("down2", Conv(ch(128), ch(256), 3, 2), (-1,)),
            ("c2f_2", blk(ch(256), ch(256), 6, True), (-1,)),
            ("down3", Conv(ch(256), ch(512), 3, 2), (-1,)),
            ("c2f_3", blk(ch(512), ch(512), 6, True), (-1,)),
            ("down4", Conv(ch(512), ch(1024), 3, 2), (-1,)),
            ("c2f_4", blk(ch(1024), ch(1024), 3, True), (-1,)),
            ("sppf", SPPF(ch(1024), ch(1024)), (-1,)),
            ("up1", Upsample(), (-1,)),
            ("cat1", Concat(), (-1, 6)),
            ("neck_p4a", blk(ch(1024) + ch(512), ch(512), 3, False), (-1,)),
            ("up2", Upsample(), (-1,)),
            ("cat2", Concat(), (-1, 4)),
            ("neck_p3", blk(ch(512) + ch(256), ch(256), 3, False), (-1,)),
            ("pan_down1", Conv(ch(256), ch(256), 3, 2), (-1,)),
            ("cat3", Concat(), (-1, 12)),
            ("neck_p4", blk(ch(256) + ch(512), ch(512), 3, False), (-1,)),
            ("pan_down2", Conv(ch(512), ch(512), 3, 2), (-1,)),
            ("cat4", Concat(), (-1, 9)),
            ("neck_p5", blk(ch(512) + ch(1024), ch(1024), 3, False), (-1,)),
        ]
        return rows, (15, 18, 21), True, ch
    k2 = _depth(2, d)
    c3k = w >= 1.0 or d >= 1.0     # scales m, l, x
    rows = [
        ("stem", Conv(in_ch, ch(64), 3, 2), (-1,)),
        ("down1", Conv(ch(64), ch(128), 3, 2), (-1,)),
        ("c3k2_1", C3k2(ch(128), ch(256), k2, c3k, 0.25), (-1,)),
        ("down2", Conv(ch(256), ch(256), 3, 2), (-1,)),
        ("c3k2_2", C3k2(ch(256), ch(512), k2, c3k, 0.25), (-1,)),
        ("down3", Conv(ch(512), ch(512), 3, 2), (-1,)),
        ("c3k2_3", C3k2(ch(512), ch(512), k2, True), (-1,)),
        ("down4", Conv(ch(512), ch(1024), 3, 2), (-1,)),
        ("c3k2_4", C3k2(ch(1024), ch(1024), k2, True), (-1,)),
        ("sppf", SPPF(ch(1024), ch(1024)), (-1,)),
        ("c2psa", C2PSA(ch(1024), k2), (-1,)),
        ("up1", Upsample(), (-1,)),
        ("cat1", Concat(), (-1, 6)),
        ("neck_p4a", C3k2(ch(1024) + ch(512), ch(512), k2, c3k), (-1,)),
        ("up2", Upsample(), (-1,)),
        ("cat2", Concat(), (-1, 4)),
        ("neck_p3", C3k2(ch(512) + ch(512), ch(256), k2, c3k), (-1,)),
        ("pan_down1", Conv(ch(256), ch(256), 3, 2), (-1,)),
        ("cat3", Concat(), (-1, 13)),
        ("neck_p4", C3k2(ch(256) + ch(512), ch(512), k2, c3k), (-1,)),
        ("pan_down2", Conv(ch(512), ch(512), 3, 2), (-1,)),
        ("cat4", Concat(), (-1, 10)),
        ("neck_p5", C3k2(ch(512) + ch(1024), ch(1024), k2, True), (-1,)),
    ]
    return rows, (16, 19, 22), False, ch


class YOLO(nn.Module):
    """forward(x [B, 3, S, S]) -> per level (box [B, 64, h, w],
    cls [B, nc, h, w])."""

    def __init__(self, name: str, nc: int = 5, in_ch: int = 3):
        super().__init__()
        version, scale = parse_name(name)
        d, w, mc = SCALES[version][scale]
        rows, self.out_idx, legacy, ch = _layers(version, d, w, mc, in_ch)
        self.graph = [(n, frm) for n, _, frm in rows]
        for n, module, _ in rows:
            self.add_module(n, module)
        self.head = DetectHead(nc, (ch(256), ch(512), ch(1024)), legacy)
        self.nc = nc

    def forward(self, x):
        saved = []
        for n, frm in self.graph:
            ins = [x if j == -1 else saved[j] for j in frm]
            x = getattr(self, n)(ins if len(frm) > 1 else ins[0])
            saved.append(x)
        return self.head([saved[i] for i in self.out_idx])


class exact_f32:
    """TF32 off for the reference's float32 on the card (cuDNN's convs and
    cuBLAS's products would otherwise round operands to TF32); restored
    after."""

    def __enter__(self):
        self.saved = (torch.backends.cudnn.allow_tf32,
                      torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = self.saved


def npz_key(name: str) -> str:
    return name.replace(".", "/")


def leaves(model: nn.Module):
    """(npz key, tensor) of every parameter and statistic, in a fixed
    order."""
    return [(npz_key(k), v) for k, v in model.state_dict().items()]


def anchors(img_size: int, device):
    """Grid-cell centres [A, 2] (grid units) and strides [A, 1], levels in
    stride order, (h, w) row-major inside a level."""
    pts, strs = [], []
    for s in STRIDES:
        n = img_size // s
        c = torch.arange(n, dtype=torch.float32, device=device) + 0.5
        yy, xx = torch.meshgrid(c, c, indexing="ij")
        pts.append(torch.stack([xx.reshape(-1), yy.reshape(-1)], -1))
        strs.append(torch.full((n * n, 1), float(s), device=device))
    return torch.cat(pts), torch.cat(strs)


def decode(raw, img_size: int):
    """Head maps -> (boxes xyxy [B, A, 4] in input pixels, class scores
    [B, A, nc]): the DFL's softmax expectation of each side's distance."""
    dist = torch.cat([b.permute(0, 2, 3, 1).reshape(b.shape[0], -1, 4,
                                                     REG_MAX)
                      for b, _ in raw], 1)
    logits = torch.cat([c.permute(0, 2, 3, 1).reshape(c.shape[0], -1,
                                                       c.shape[1])
                        for _, c in raw], 1)
    ltrb = (torch.softmax(dist.float(), -1)
            * torch.arange(REG_MAX, device=dist.device)).sum(-1)
    pts, strides = anchors(img_size, dist.device)
    boxes = torch.cat([(pts - ltrb[..., :2]) * strides,
                       (pts + ltrb[..., 2:]) * strides], -1)
    return boxes, torch.sigmoid(logits.float()), logits.float()


def load_npz(model: nn.Module, path: str) -> nn.Module:
    """Load weights in the npz format (4-D kernels HWIO) into `model`."""
    with np.load(path) as data:
        state = {}
        for k, v in model.state_dict().items():
            a = data[npz_key(k)].astype(np.float32)
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            state[k] = torch.from_numpy(np.ascontiguousarray(a))
    model.load_state_dict(state)
    return model
