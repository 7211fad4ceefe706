"""Seeded random weights for a configuration, drawn on the device in a few
large calls, calibrated on the cell's own inputs, and written in the npz
format that `cli.run --weights` and `reference.model.load_npz` read.

The configuration's `init` group sets the draw and the calibration:
  conv_gain  every conv kernel ~ N(0, (conv_gain / sqrt(fan_in))^2)
  bn         [lo, hi, half]: BatchNorm's gamma ~ U(lo, hi), beta
             ~ U(-half, half)
  var_floor  each BatchNorm variance is its batch variance plus var_floor
             times its layer's mean batch variance
  cls_std    spread of each class logit over the calibration anchors
  box_std    spread of each DFL logit over them
  box_decay  the DFL logits' mean: -box_decay * bin, so distances are
             short and boxes small
  cls_rate   anchors a tile over the run's score threshold (see calibrate)
Calibration (`calibrate`) sets BatchNorm's statistics from a training-mode
forward over a batch of model inputs, layer after layer normalised, then
scales each of the head's last convs so that its outputs spread by
cls_std or box_std around their intended means: for the class logits
ultralytics' priors, log(5 / nc / (640 / stride)^2).  A random detector so
drawn fires on a few anchors a tile with small boxes, steadily from seed to
seed, and its outputs move under rounding about as a trained model's do.
Uncalibrated, a default conv init leaves every score at its prior; with
BatchNorm's bare batch statistics the deep random network amplifies
rounding until bf16 moves class logits by a third of their spread.
"""

from __future__ import annotations

import json
import math

import numpy as np
import torch

from reference.model import REG_MAX, STRIDES, Conv, leaves


def draw(model: torch.nn.Module, seed: int, init: dict,
         device) -> torch.nn.Module:
    """Fill `model` (on `device`) in place from `seed`: one normal draw
    for every kernel, one uniform draw for every BatchNorm leaf."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    named = leaves(model)
    with torch.no_grad():
        kernels = [t for k, t in named if k.endswith("/w")]
        flat = torch.randn(sum(t.numel() for t in kernels), generator=gen,
                           device=device)
        off = 0
        for t in kernels:
            t.copy_(flat[off:off + t.numel()].view_as(t)
                    * (init["conv_gain"] / math.sqrt(t[0].numel())))
            off += t.numel()
        bn = [(k, t) for k, t in named
              if k.endswith(("/bn/gamma", "/bn/beta"))]
        uni = torch.rand(sum(t.numel() for _, t in bn), generator=gen,
                         device=device)
        for k, t in named:
            if k.endswith("/b"):
                t.zero_()
        lo, hi, half = init["bn"]
        off = 0
        for key, t in bn:
            u = uni[off:off + t.numel()].view_as(t)
            off += t.numel()
            t.copy_(lo + (hi - lo) * u if key.endswith("gamma")
                    else (2 * u - 1) * half)
    return model


@torch.no_grad()
def calibrate(model: torch.nn.Module, x: torch.Tensor, init: dict,
              score_thr: float | None = None, train: bool = False) -> None:
    """BatchNorm's statistics, then the head's last convs, from the model
    inputs x [B, 3, S, S] (see the module's docstring), the head from a
    forward in the mode the model will run in (`train`: BatchNorm on the
    batch's statistics).  With `score_thr`, one shift of every class bias
    then puts `cls_rate` anchors a tile of x over the threshold, so that
    the detector fires as often whatever the seed."""
    Conv.record = {}
    try:
        model.train()
        model(x)
        for conv, (mean, var) in Conv.record.items():
            conv.bn.mean.copy_(mean)
            conv.bn.var.copy_(var + init["var_floor"] * var.mean())
    finally:
        Conv.record = None
        model.eval()
    finals = [(br[-1], "box", i) for i, br in enumerate(model.head.box)]
    finals += [(br[-1], "cls", i) for i, br in enumerate(model.head.cls)]
    seen = {}
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: seen.__setitem__(mod, out - mod.b[:, None,
                                                                None]))
        for m, _, _ in finals]
    model.train(train)
    model(x)
    model.eval()
    for h in hooks:
        h.remove()
    nc = model.nc
    bins = torch.arange(REG_MAX, dtype=torch.float32, device=x.device)
    for m, kind, level in finals:
        var, mean = torch.var_mean(seen[m], dim=(0, 2, 3))
        if kind == "cls":
            target = torch.full_like(mean, math.log(
                5.0 / nc / (640.0 / STRIDES[level]) ** 2))
            spread = init["cls_std"]
        else:
            target = (-init["box_decay"] * bins).repeat(4)
            spread = init["box_std"]
        scale = spread / torch.sqrt(var + 1e-12)
        m.w.mul_(scale[:, None, None, None])
        m.b.copy_(target - mean * scale)
    if score_thr is None:
        return
    best = torch.cat([c.amax(1).flatten(1) for _, c in model(x)], 1)
    k = max(1, round(init["cls_rate"] * x.shape[0]))
    # the threshold halfway between the k-th and the next anchor, so none
    # of them sits on it
    top = best.flatten().topk(k + 1).values
    shift = math.log(score_thr / (1 - score_thr)) - 0.5 * (top[-2] + top[-1])
    for br in model.head.cls:
        br[-1].b.add_(shift)


def save_npz(model: torch.nn.Module, path: str, meta: dict) -> str:
    """Write the weights (4-D kernels OIHW -> HWIO) with a `__meta__`
    entry naming the architecture."""
    flat = {}
    for key, t in leaves(model):
        a = t.detach().float().cpu().numpy()
        flat[key] = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a
    flat["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(path, **flat)
    return path
