"""Plain PyTorch YOLO12 for the benchmark's reference model.

Written from ultralytics' modules AAttn, ABlock and A2C2f
(ultralytics/nn/modules/block.py) and the rows of
cfg/models/12/yolo12.yaml as ultralytics' parse_model reads them (C3k2
with c3k at scales m/l/x; every A2C2f with residual=True and mlp_ratio
1.2 at l/x), in float32 with no kernels, no fusion and no caching, TF32
off on the card (`reference.model.exact_f32`, which every caller of the
reference holds).  Imports nothing of the program.

`YOLO12("yolo12l")` is `reference.model.YOLO` with yolo12.yaml's layer
table: the same forward, head, npz walk, draw and calibration.  Its
parameters carry the npz names of the program (`a2c2f_1/m/0/1/attn/qkv/w`,
`a2c2f_1/gamma`), so one weight file serves both.

Departures from ultralytics, shared with the program's npz format and
with reference.model: BatchNorm eps 1e-3, the DFL decoded as a softmax
expectation, and the layer scale gamma drawn at order 1
(`draw_layer_scale`, the configuration's `init.layer_scale`) where
ultralytics initialises it to 0.01, which would scale the attention stages
out of every comparison.  The stride-2 convs of layers 1 and 3 are dense,
as the published counts of YOLO12 (26.4 M parameters, 88.9 GFLOPs at 640
px for scale l) have them.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from reference import model as base
from reference.model import C3, C3k2, Concat, Conv, Upsample, _depth


class AAttn(nn.Module):
    """Area attention: qkv read row-major as [B, N, 3C], `area` strips of
    N / area positions, each head's 3 * hd channels [q | k | v]."""

    def __init__(self, dim, num_heads, area=1):
        super().__init__()
        self.area, self.heads = area, num_heads
        self.hd = dim // num_heads
        self.qkv = Conv(dim, 3 * dim, act=False)
        self.proj = Conv(dim, dim, act=False)
        self.pe = Conv(dim, dim, 7, groups=dim, act=False)

    def forward(self, x):
        b, c, h, w = x.shape
        n, a, hd = h * w, self.area, self.hd
        qkv = self.qkv(x).flatten(2).transpose(1, 2).reshape(
            b * a, n // a, self.heads, 3 * hd).transpose(1, 2)
        q, k, v = qkv.split(hd, dim=-1)              # [B*a, heads, N/a, hd]
        att = torch.softmax((q @ k.transpose(-1, -2)) * hd ** -0.5, dim=-1)
        out = att @ v
        out, v = (t.transpose(1, 2).reshape(b, h, w, c).permute(0, 3, 1, 2)
                  for t in (out, v))
        return self.proj(out + self.pe(v))


class ABlock(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio=1.2, area=1):
        super().__init__()
        self.attn = AAttn(dim, num_heads, area)
        hidden = int(dim * mlp_ratio)
        self.mlp = nn.Sequential(Conv(dim, hidden), Conv(hidden, dim,
                                                         act=False))

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.mlp(x)


class A2C2f(nn.Module):
    """R-ELAN: n blocks (two ABlocks with a2, else a C3k) on cv1's
    output, cv2 over all of them; with a2 and residual, x + gamma * out."""

    def __init__(self, cin, cout, n=1, a2=True, area=1, residual=False,
                 mlp_ratio=2.0):
        super().__init__()
        c_ = int(cout * 0.5)
        self.cv1 = Conv(cin, c_)
        self.cv2 = Conv((1 + n) * c_, cout)
        self.gamma = (nn.Parameter(torch.full((cout,), 0.01))
                      if a2 and residual else None)
        self.m = nn.ModuleList(
            nn.Sequential(*(ABlock(c_, c_ // 32, mlp_ratio, area)
                            for _ in range(2)))
            if a2 else C3(c_, c_, 2, True) for _ in range(n))

    def forward(self, x):
        ys = [self.cv1(x)]
        for block in self.m:
            ys.append(block(ys[-1]))
        y = self.cv2(torch.cat(ys, 1))
        return y if self.gamma is None else x + self.gamma[:, None,
                                                           None] * y


def parse_name(name: str) -> str:
    """'yolo12l' -> 'l'."""
    if name.startswith("yolo12") and len(name) == 7 and name[6] in "nsmlx":
        return name[6]
    raise ValueError(f"unknown model {name!r}")


def layers(d, w, mc, in_ch):
    """yolo12.yaml's rows at depth d, width w and channel cap mc, as
    reference.model's table of v8 and v11."""

    def ch(c):
        return base.make_divisible(min(c, mc) * w, 8)

    k2, k4 = _depth(2, d), _depth(4, d)
    c3k = w >= 1.0 or d >= 1.0     # scales m, l, x
    extra = (True, 1.2) if d >= 1.0 else ()      # scales l, x
    rows = [
        ("stem", Conv(in_ch, ch(64), 3, 2), (-1,)),
        ("down1", Conv(ch(64), ch(128), 3, 2), (-1,)),
        ("c3k2_1", C3k2(ch(128), ch(256), k2, c3k, 0.25), (-1,)),
        ("down2", Conv(ch(256), ch(256), 3, 2), (-1,)),
        ("c3k2_2", C3k2(ch(256), ch(512), k2, c3k, 0.25), (-1,)),
        ("down3", Conv(ch(512), ch(512), 3, 2), (-1,)),
        ("a2c2f_1", A2C2f(ch(512), ch(512), k4, True, 4, *extra), (-1,)),
        ("down4", Conv(ch(512), ch(1024), 3, 2), (-1,)),
        ("a2c2f_2", A2C2f(ch(1024), ch(1024), k4, True, 1, *extra), (-1,)),
        ("up1", Upsample(), (-1,)),
        ("cat1", Concat(), (-1, 6)),
        ("neck_p4a", A2C2f(ch(1024) + ch(512), ch(512), k2, False, -1,
                           *extra), (-1,)),
        ("up2", Upsample(), (-1,)),
        ("cat2", Concat(), (-1, 4)),
        ("neck_p3", A2C2f(ch(512) + ch(512), ch(256), k2, False, -1,
                          *extra), (-1,)),
        ("pan_down1", Conv(ch(256), ch(256), 3, 2), (-1,)),
        ("cat3", Concat(), (-1, 11)),
        ("neck_p4", A2C2f(ch(256) + ch(512), ch(512), k2, False, -1,
                          *extra), (-1,)),
        ("pan_down2", Conv(ch(512), ch(512), 3, 2), (-1,)),
        ("cat4", Concat(), (-1, 8)),
        ("neck_p5", C3k2(ch(512) + ch(1024), ch(1024), k2, True), (-1,)),
    ]
    return rows, (14, 17, 20), False, ch


class YOLO12(base.YOLO):
    """reference.model.YOLO built from yolo12.yaml's rows (scales as
    YOLO11's)."""

    def __init__(self, name: str, nc: int = 5, in_ch: int = 3):
        nn.Module.__init__(self)
        d, w, mc = base.SCALES["v11"][parse_name(name)]
        rows, self.out_idx, legacy, ch = layers(d, w, mc, in_ch)
        self.graph = [(n, frm) for n, _, frm in rows]
        for n, module, _ in rows:
            self.add_module(n, module)
        self.head = base.DetectHead(nc, (ch(256), ch(512), ch(1024)), legacy)
        self.nc = nc


def build(name: str, nc: int = 5) -> nn.Module:
    """The reference model of any configuration: YOLO12 for 'yolo12<s>',
    else reference.model.YOLO."""
    return (YOLO12 if name.startswith("yolo12") else base.YOLO)(name, nc)


def draw_layer_scale(model: nn.Module, seed: int, lo_hi,
                     device) -> nn.Module:
    """Every A2C2f layer scale ~ U(lo, hi), in place, in one draw from a
    generator of its own seeded from `seed` (the weights' seed)."""
    lo, hi = lo_hi
    scales = [m.gamma for m in model.modules()
              if isinstance(m, A2C2f) and m.gamma is not None]
    if not scales:
        return model
    state = np.random.SeedSequence([int(seed), 12]).generate_state(1)[0]
    gen = torch.Generator(device=device).manual_seed(int(state))
    u = torch.rand(sum(g.numel() for g in scales), generator=gen,
                   device=device)
    off = 0
    with torch.no_grad():
        for g in scales:
            g.copy_(lo + (hi - lo) * u[off:off + g.numel()])
            off += g.numel()
    return model
