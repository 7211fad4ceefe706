"""Operation and byte counts of the work, from the reference model's
shapes on the meta device (no memory, no kernels), and the peaks they are
held to.

The roofline shares count the work of the operation, not of the program's
implementation: each input byte read once, each output byte written once.
"""

from __future__ import annotations

import functools
import json
import os

import torch
from torch.utils.flop_counter import FlopCounterMode

from reference.model import YOLO, Conv, Conv2dRaw

PEAKS = json.load(open(os.path.join(os.path.dirname(__file__),
                                    "peaks.json")))


@functools.lru_cache(maxsize=None)
def model_flops(name: str, nc: int, size: int, backward: bool = False):
    """FLOPs of one image at size x size: the forward, or the forward and
    the backward (gradients of weights and inputs), as FlopCounterMode
    counts them (2 a multiply-add; convolutions and matrix products)."""
    model = YOLO(name, nc).to("meta")
    model.train(backward)
    x = torch.zeros(1, 3, size, size, device="meta",
                    requires_grad=backward)
    with FlopCounterMode(display=False) as fc:
        out = model(x)
        if backward:
            sum(b.sum() + c.sum() for b, c in out).backward()
    return int(fc.get_total_flops())


@functools.lru_cache(maxsize=None)
def conv_outputs(name: str, nc: int, batch: int, size: int):
    """Shapes [B, C, H, W] of every conv's output in one forward, in
    call order."""
    model = YOLO(name, nc).to("meta").eval()
    shapes = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: shapes.append(tuple(out.shape)))
        for m in model.modules() if isinstance(m, (Conv, Conv2dRaw))]
    with torch.no_grad():
        model(torch.zeros(batch, 3, size, size, device="meta"))
    for h in hooks:
        h.remove()
    return tuple(shapes)


def epilogue_bytes(name: str, nc: int, batch: int, size: int) -> int:
    """A bf16 inference forward's conv epilogues: each conv's f32 output
    read once, its bf16 result written once, and its f32 per-channel
    shift (BatchNorm folded into the weights) read once."""
    return sum(b * c * h * w * (4 + 2) + c * 4
               for b, c, h, w in conv_outputs(name, nc, batch, size))


def plane_bytes(planes: int, h: int, w: int, passes: int) -> int:
    """f32 planes read (passes=1) or read and written (passes=2) once."""
    return planes * h * w * 4 * passes


def share(nbytes: float, seconds: float, flops: float = 0.0):
    """Roofline share in % of `seconds` of device time: the larger of
    bytes over the memory rate and operations over the bf16 peak, over
    the time; None without time."""
    if seconds <= 0:
        return None
    least = max(nbytes / PEAKS["hbm_bytes_per_s"],
                flops / PEAKS["bf16_flops_per_s"])
    return 100.0 * least / seconds
