"""Batched detection: letterbox -> YOLO -> DFL decode -> NMS ->
unletterbox.

Counterpart of caesar_yolo_tpu/detect/predictor.py.  The reference jits
one XLA program per input shape; here the same steps run eagerly on the
model's device.  On CUDA the model runs in bf16 in channels_last memory.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from caesar_yolo_tpu_torch import logger
from caesar_yolo_tpu_torch.detect.letterbox import (
    PAD_VALUE,
    letterbox_nchw,
    unletterbox_boxes,
)
from caesar_yolo_tpu_torch.detect.nms import DEFAULT_PRE_NMS, nms_batch
from caesar_yolo_tpu_torch.models.layers import (cast_weights, fuse_tree,
                                                 pack_int8)
from caesar_yolo_tpu_torch.models.yolo import YOLO, decode_dfl
from caesar_yolo_tpu_torch.utils.device import resolve_device

# inference's compute dtype: the default of the Predictor and the
# TileEngine, and that of the model cli.run prepares from npz weights
COMPUTE_DTYPE = torch.bfloat16


def prepare_model(model: YOLO, *, dtype: torch.dtype | None = None,
                  device: torch.device) -> YOLO:
    """The inference model of `model` in `dtype` on `device`: `model`
    itself where it is one already (its `compute_dtype` is `dtype` and its
    weights are on `device`), else a copy, so the caller's modules are
    never changed.  The copy has BN folded in f32 (the reference's
    fuse_model_params / _fuse_head; a Conv without BatchNorm, as an int8
    model's, stays as it is), conv weights cast to `dtype` (biases stay
    f32; an int8 model's quantized Convs keep their int8 weights and f32
    scales), moved to `device` (channels_last on CUDA, and the int8
    weights packed as K9 reads them), and `dtype` as its `compute_dtype`.
    A None `dtype` is the model's own, or COMPUTE_DTYPE (read at the call)
    for a model that is not yet an inference model."""
    if dtype is None:
        dtype = model.compute_dtype or COMPUTE_DTYPE
    at = next(model.parameters()).device
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if model.compute_dtype == dtype and at == device:
        return model
    model = fuse_tree(copy.deepcopy(model).float().eval())
    model = cast_weights(model.to(device=device), dtype)
    if device.type == "cuda":
        model = pack_int8(model.to(memory_format=torch.channels_last))
    model.compute_dtype = dtype
    return model


def detect_images(model: YOLO, images: torch.Tensor, *, img_size: int,
                  score_thr: float, iou_thr: float, max_det: int,
                  pre_nms: int, input_scale: float = 1.0,
                  channel_flip: bool = False):
    """images [B, H, W, C] f32 on the model's device -> (boxes[B, max_det,
    4] xyxy in image coords, scores, class_ids, valid, n_dropped[B]).
    input_scale and channel_flip are the ultralytics-parity options of
    caesar_yolo_tpu/detect/predictor.py: the letterbox pads with
    PAD_VALUE / input_scale, then the channels are reversed and the pixels
    scaled, so that ultralytics' 114 pad before its /255 is matched."""
    h, w = images.shape[1:3]
    x = letterbox_nchw(images.permute(0, 3, 1, 2), img_size,
                       pad_value=PAD_VALUE / input_scale)
    if channel_flip:
        x = x.flip(1)
    if input_scale != 1.0:
        x = x * input_scale
    x = x.to(model.compute_dtype)
    if x.is_cuda:
        x = x.contiguous(memory_format=torch.channels_last)
    boxes, scores = decode_dfl(model(x), img_size)
    bsel, ssel, csel, vsel, ndrop = nms_batch(
        boxes, scores, conf_thr=score_thr, iou_thr=iou_thr,
        max_det=max_det, pre_nms=pre_nms)
    return unletterbox_boxes(bsel, h, w, img_size), ssel, csel, vsel, ndrop


class Predictor:
    """Batched detector on one device.

    predict_batch(images[B, H, W, C] f32 in [0, 1]) -> device tensors
      (boxes[B, MAXDET, 4] xyxy in image coords, scores[B, MAXDET],
       class_ids[B, MAXDET], valid[B, MAXDET], n_dropped[B]).
    `device` defaults to CUDA (and raises without it); pass "cpu" to run
    on the CPU.  `input_scale` multiplies the letterboxed pixels and
    `channel_flip` reverses their channels (BGR -> RGB), for images in
    ultralytics' 0-255 convention (1/255 and True reproduce its
    preprocessing); the defaults leave the path as it is.  The predictor
    runs prepare_model's inference model of `model` in `compute_dtype`
    (None: the model's own, or COMPUTE_DTYPE).
    """

    def __init__(self, model: YOLO, *,
                 compute_dtype: torch.dtype | None = None, device=None,
                 img_size: int = 640, score_thr: float = 0.7,
                 iou_thr: float = 0.5, max_det: int = 300,
                 pre_nms: int = DEFAULT_PRE_NMS, input_scale: float = 1.0,
                 channel_flip: bool = False):
        self.device = resolve_device(device)
        self.model = prepare_model(model, dtype=compute_dtype,
                                   device=self.device)
        self.in_channels = model.in_channels
        self.img_size = img_size
        self.score_thr = score_thr
        self.iou_thr = iou_thr
        self.max_det = max_det
        self.pre_nms = pre_nms
        self.input_scale = input_scale
        self.channel_flip = channel_flip

    @torch.inference_mode()
    def predict_batch(self, images):
        images = torch.as_tensor(images, device=self.device).float()
        if images.ndim == 3:
            images = images[None]
        return detect_images(self.model, images, img_size=self.img_size,
                             score_thr=self.score_thr, iou_thr=self.iou_thr,
                             max_det=self.max_det, pre_nms=self.pre_nms,
                             input_scale=self.input_scale,
                             channel_flip=self.channel_flip)

    def predict_image(self, image):
        """Single [H, W, C] image -> host numpy (boxes[N, 4], scores[N],
        class_ids[N]) with the padding stripped."""
        bsel, ssel, csel, vsel, ndrop = (
            t[0].cpu().numpy() for t in self.predict_batch(image))
        if int(ndrop):
            logger.warning(
                "NMS pre-filter dropped %d above-threshold candidates "
                "(pre_nms=%d too small for this field; raise it)",
                int(ndrop), self.pre_nms)
        return bsel[vsel], ssel[vsel], csel[vsel]
