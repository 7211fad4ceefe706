"""The batched tile-detection engine on one GPU.

Counterpart of caesar_yolo_tpu/parallel/engine.py (`make_tile_step`,
`TileEngine`): per tile batch, gray -> 3 channels, the preprocessing
pipeline, the degenerate-channel guard, letterbox, the YOLO forward pass
(bf16 on CUDA), DFL decode, fixed-shape NMS and unletterbox, with
`tile_ok` masking the detections of tiles that cannot be predicted on.
The device mesh and mosaic-resident tiling are not ported yet (ROADMAP.md,
Queue 1 item 7).
"""

from __future__ import annotations

import numpy as np
import torch

from caesar_yolo_tpu_torch.detect.nms import DEFAULT_PRE_NMS
from caesar_yolo_tpu_torch.detect.predictor import detect_images, prepare_model
from caesar_yolo_tpu_torch.models.yolo import YOLO
from caesar_yolo_tpu_torch.ops.transforms import prepare_tiles
from caesar_yolo_tpu_torch.utils.device import resolve_device


def make_tile_step(model: YOLO, *, preprocessor=None, img_size: int = 640,
                   score_thr: float = 0.25, iou_thr: float = 0.5,
                   max_det: int = 300, pre_nms: int = DEFAULT_PRE_NMS):
    """step(tiles[B, H, W, C]) -> (boxes in tile coords, scores, cls,
    valid, tile_ok, n_dropped) for a model already on its device and in
    its compute dtype (predictor.prepare_model)."""
    nchan = model.in_channels

    def step(tiles):
        imgs, tile_ok = prepare_tiles(tiles, preprocessor, nchan)
        bsel, ssel, csel, vsel, ndrop = detect_images(
            model, imgs, img_size=img_size, score_thr=score_thr,
            iou_thr=iou_thr, max_det=max_det, pre_nms=pre_nms)
        return bsel, ssel, csel, vsel & tile_ok[:, None], tile_ok, ndrop

    return step


class TileEngine:
    """Batch detector for fixed-size tiles on one device.

    process(tiles[B, H, W, C]) -> host numpy
      (boxes[B, MAXDET, 4] xyxy in TILE coords, scores[B, MAXDET],
       class_ids[B, MAXDET], valid[B, MAXDET], tile_ok[B], n_dropped[B]).
    n_dropped counts above-threshold candidates truncated by the pre_nms
    window (callers must log nonzero counts).

    `device` defaults to CUDA (and raises without it); pass "cpu" to run
    on the CPU.  relay_dtype="bfloat16" ships tiles host->device in bf16
    (half the bytes, 8-bit mantissa) and upcasts them on the device.
    """

    def __init__(self, model: YOLO, *, preprocessor=None,
                 img_size: int = 640, score_thr: float = 0.7,
                 iou_thr: float = 0.5, max_det: int = 300,
                 pre_nms: int = DEFAULT_PRE_NMS,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 fuse: bool = True, relay_dtype: str = "float32",
                 device=None):
        self.device = resolve_device(device)
        self.relay_dtype = (torch.bfloat16
                            if str(relay_dtype) in ("bfloat16", "bf16")
                            else torch.float32)
        self._fuse = fuse
        self.compute_dtype = compute_dtype
        self._step_kwargs = dict(
            preprocessor=preprocessor, img_size=img_size,
            score_thr=score_thr, iou_thr=iou_thr, max_det=max_det,
            pre_nms=pre_nms)
        self.update_params(model)

    def update_params(self, model: YOLO) -> None:
        """Swap in the weights `model` carries (e.g. a trainer's EMA model,
        for validation during training) with the same treatment as at
        construction: prepare_model copies it, folds BatchNorm and casts,
        so the caller's modules are never changed."""
        self.model = prepare_model(model, fuse=self._fuse,
                                   dtype=self.compute_dtype,
                                   device=self.device)
        self._step = make_tile_step(self.model, **self._step_kwargs)

    def put_tiles(self, tiles: np.ndarray) -> torch.Tensor:
        """Stage a host tile batch on the device in the relay dtype
        (pinned and asynchronous on CUDA)."""
        t = torch.from_numpy(np.ascontiguousarray(tiles, np.float32))
        t = t.to(self.relay_dtype)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    @torch.inference_mode()
    def process_async(self, tiles):
        """Enqueue one batch without waiting for the device; returns
        device tensors.  Takes a host array or a staged tensor."""
        if isinstance(tiles, np.ndarray):
            tiles = self.put_tiles(tiles)
        return self._step(tiles)

    def process(self, tiles):
        return tuple(t.cpu().numpy() for t in self.process_async(tiles))
