"""Survey fields of a configuration with area attention (YOLO12), through
`caesar_yolo_tpu_torch.cli.run`, one call a field.

The survey entry (entries/survey.py: its traffic, fields, window, units
and check) with three differences:
  - the reference model is YOLO12 (reference/yolo12.py), and the
    weights' draw also draws every A2C2f layer scale from the weights'
    seed, U(init.layer_scale), before the calibration;
  - set-up first asks the program to build the configuration's model and
    stops the run at once where it cannot (a program without YOLO12);
  - the variant `fp8` puts the control in the program's place: the
    reference with every conv's operands rounded to float8 e4m3 (the
    precision below the configuration's bf16) writes each field's catalog.
K2's launches are counted against the trace besides the survey entry's
kernels.
"""

from __future__ import annotations

import json
import os

import torch

from harness.core import BENCH_DIR, load_module, log
from reference import weights
from reference.model import Conv
from reference.yolo12 import YOLO12, draw_layer_scale

base = load_module(os.path.join(BENCH_DIR, "entries", "survey.py"),
                   "bench_entry_survey_of_survey12")

KERNEL_COUNTERS = dict(
    base.KERNEL_COUNTERS,
    attn_fwd_mma_kernel="caesar_yolo_tpu_torch.models.cuda_attn:"
                        "attention.launches")


def draw(model, seed, init, device):
    """reference/weights.py's draw, then the layer scales."""
    weights.draw(model, seed, init, device)
    return draw_layer_scale(model, seed, init["layer_scale"], device)


# the survey entry's weights and reference catalog build and draw
# through these
base.YOLO, base.draw = YOLO12, draw


def setup(ctx):
    from caesar_yolo_tpu_torch.models.yolo import build_model
    cfg = ctx.cell.config
    with ctx.spans("setup.build_check"):
        build_model(cfg["model"], num_classes=cfg["nc"])
    base.setup(ctx)


def kernel_checks(ctx):
    return dict(KERNEL_COUNTERS)


def fp8(t):
    """The tensor rounded to float8 e4m3 under a per-tensor scale (its
    largest magnitude to e4m3's 448)."""
    scale = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


def check(ctx):
    """The survey entry's check; under the variant fp8, after the
    control's catalog has replaced every field's."""
    if ctx.variant == "fp8":
        Conv.quant = fp8
        try:
            control = base.reference_catalog(ctx)
        finally:
            Conv.quant = None
        for u in ctx.units:
            path = os.path.join(ctx.tmp, u["catalog"])
            if u["rc"] == 0 and os.path.exists(path):
                with open(path, "w") as f:
                    json.dump({"sources": control}, f)
        log(f"control: the fp8 reference's catalog ({len(control)} "
            f"sources) in the program's place")
    return base.check(ctx)


window = base.window
memory_peak = base.memory_peak
attempted = base.attempted
end_to_end = base.end_to_end
release = base.release
