"""Post-training int8 quantization (PTQ) for inference.

Counterpart of caesar_yolo_tpu/models/quant.py, with its scheme:
  - weights: per-output-channel scale ws[cout] = max|w| / 127 over
    (cin, kh, kw), after BatchNorm fusion, and wq = clip(round(w / ws),
    -127, 127) in int8 (round half to even);
  - activations: one static input scale a conv, xs = max(amax, 1e-12) /
    127, amax the largest |x| the conv saw in calibration forwards of the
    fused model run in the calibration inputs' dtype (bf16 by default, as
    the reference's calibration_inputs_from_tiles);
  - compute: layers.Conv's int8 forward (models/cuda_qconv.py, kernel K9
    on the card);
  - kept in float: grouped convs (the v11 head's and C2PSA's DWConvs), the
    head's final Conv2dRaw projections and any conv calibration never saw.

Usage:
    qmodel = quantize_model(model, calibration_inputs_from_tiles(tiles))
    engine = TileEngine(qmodel, ...)     # or a Predictor

The ranges are keyed by module path, not by module object: calibration
runs on a copy cast to the inputs' dtype, and quantization then reads the
f32 fused weights of another copy.
"""

from __future__ import annotations

import copy

import torch

from caesar_yolo_tpu_torch.models.layers import (Conv, cast_weights,
                                                 fuse_tree, quant_calibrate)
from caesar_yolo_tpu_torch.models.yolo import YOLO
from caesar_yolo_tpu_torch.utils.device import resolve_device


def quantize_weights(w: torch.Tensor, amax: float):
    """Fused f32 weights [cout, cin, k, k] and the input's calibrated
    max|x| -> (wq int8, ws f32 [cout], xs f32 scalar) (_quantize_conv,
    quant.py:41-49)."""
    w = w.detach().float()
    ws = w.abs().amax(dim=(1, 2, 3)) / 127.0
    ws = torch.where(ws > 0, ws, torch.ones_like(ws))
    wq = torch.clamp(torch.round(w / ws[:, None, None, None]), -127,
                     127).to(torch.int8)
    xs = torch.tensor(max(amax, 1e-12) / 127.0, dtype=torch.float32)
    return wq, ws, xs


@torch.inference_mode()
def calibrate_ranges(model: YOLO, sample_inputs) -> dict:
    """Forwards of `model` (fused, f32) over the model inputs
    `sample_inputs` ([B, C, S, S] each), with its weights cast to the
    inputs' dtype on their device -> {module path: max|input|} of every
    Conv the forwards reached."""
    x0 = sample_inputs[0]
    cal = cast_weights(copy.deepcopy(model).to(x0.device), x0.dtype)
    if x0.is_cuda:
        cal = cal.to(memory_format=torch.channels_last)
    names = {m: n for n, m in cal.named_modules()}
    with quant_calibrate(cal) as ranges:
        for xx in sample_inputs:
            cal(xx)
    return {names[m]: amax for m, amax in ranges.items()}


def quantize_model(model: YOLO, sample_inputs) -> YOLO:
    """BN-fuse, calibrate on `sample_inputs` (an iterable of model-input
    batches [B, C, S, S] in the compute dtype) and return a new model, on
    the CPU in f32 and not yet an inference model (its `compute_dtype` is
    None), whose calibrated dense Convs are int8."""
    qmodel = copy.deepcopy(model).cpu().float().eval()
    qmodel = qmodel.to(memory_format=torch.contiguous_format)
    qmodel.compute_dtype = None
    fuse_tree(qmodel)
    ranges = calibrate_ranges(qmodel, list(sample_inputs))
    for name, m in qmodel.named_modules():
        # dense Convs only: grouped ones stay float
        if (isinstance(m, Conv) and m.groups == 1
                and ranges.get(name, 0.0) > 0.0):
            m.to_int8(*quantize_weights(m.w, ranges[name]))
    return qmodel


def int8_layout(model: YOLO, state: dict) -> YOLO:
    """Give `model` the structure of a fused, possibly quantized, state
    dict (the reference's fused or quantized params carried across,
    models/convert.py): BatchNorm fused, and each Conv whose `wq` the
    state holds made int8 (placeholders, which load_state_dict then
    fills)."""
    fuse_tree(model)
    for name, m in model.named_modules():
        key = f"{name}.wq"
        if isinstance(m, Conv) and key in state:
            cout = state[key].shape[0]
            m.to_int8(torch.zeros(state[key].shape, dtype=torch.int8),
                      torch.ones(cout), torch.ones(()))
    return model


def calibration_inputs_from_tiles(tiles, *, preprocessor=None,
                                  img_size: int = 640, nchan: int = 3,
                                  compute_dtype=torch.bfloat16, device=None):
    """Model calibration inputs from raw tiles [B, H, W, C] with the
    preparation the TileEngine applies (gray -> nchan channels, the
    preprocessing pipeline's batch form, letterbox, compute dtype) ->
    [one [B, nchan, S, S] batch] on `device` (CUDA by default; "cpu" for
    the CPU), channels_last on CUDA."""
    from caesar_yolo_tpu_torch.detect.letterbox import letterbox_nchw

    dev = resolve_device(device)
    x = torch.as_tensor(tiles).to(dev, torch.float32)
    if x.shape[-1] == 1 and nchan > 1:
        x = x.repeat(1, 1, 1, nchan)
    if preprocessor is not None:
        x, _ = preprocessor.apply_batch(x)
    if x.shape[-1] == 1 and nchan > 1:
        x = x.repeat(1, 1, 1, nchan)
    x = letterbox_nchw(x.permute(0, 3, 1, 2), img_size).to(compute_dtype)
    if x.is_cuda:
        x = x.contiguous(memory_format=torch.channels_last)
    return [x]
