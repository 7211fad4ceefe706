"""Operations and bytes of the attention of one forward, from the
reference model's attention calls on the meta device: YOLO11's C2PSA
(`reference.model.Attention`) and YOLO12's area attention
(`reference.yolo12.AAttn`, its strips as sequences of their own).

Per call of B sequences of N positions and H heads (key width kd, value
width hd): 2 N^2 (kd + hd) FLOPs a sequence-head (q k^T and p v), and q,
k, v read once and the output written once in bf16, as the program's
kernel K2 takes them.
"""

from __future__ import annotations

import functools

import torch

from reference.model import Attention
from reference.yolo12 import AAttn, build


def _shape_of(mod, x):
    """(B, H, N, kd, hd) of one attention call on input x [b, c, h, w]."""
    b, c, h, w = x.shape
    if isinstance(mod, AAttn):
        return (b * mod.area, mod.heads, h * w // mod.area, mod.hd, mod.hd)
    return (b, mod.heads, h * w, mod.kd, mod.hd)


@functools.lru_cache(maxsize=None)
def attention_calls(name: str, nc: int, batch: int, size: int):
    """(B, H, N, kd, hd) of every attention call of one forward, in call
    order."""
    model = build(name, nc).to("meta").eval()
    calls = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: calls.append(_shape_of(mod, inp[0])))
        for m in model.modules() if isinstance(m, (Attention, AAttn))]
    with torch.no_grad():
        model(torch.zeros(batch, 3, size, size, device="meta"))
    for h in hooks:
        h.remove()
    return tuple(calls)


def attention_work(name: str, nc: int, batch: int, size: int):
    """(FLOPs, bytes) of one forward's attention calls."""
    flops = nbytes = 0
    for b, h, n, kd, hd in attention_calls(name, nc, batch, size):
        flops += 2 * b * h * n * n * (kd + hd)
        nbytes += 2 * b * h * n * (2 * kd + 2 * hd)
    return flops, nbytes
