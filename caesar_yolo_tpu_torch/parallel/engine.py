"""The batched tile-detection engine on one GPU.

Counterpart of caesar_yolo_tpu/parallel/engine.py (`make_tile_step`,
`TileEngine`): per tile batch, gray -> 3 channels, the preprocessing
pipeline, the degenerate-channel guard, letterbox, the YOLO forward pass
(bf16 on CUDA), DFL decode, fixed-shape NMS and unletterbox, with
`tile_ok` masking the detections of tiles that cannot be predicted on.

Device-resident tiling (the reference's engine.py:204-305): a mosaic, or
a full-width band of one, is shipped to the device once (`put_mosaic`),
optionally preprocessed there as one plane (`preprocess_mosaic`, the
global statistics context), and batches of windows are cut from it on
the device by one gather (`process_mosaic_async`).  On several GPUs each
process runs its own engine (parallel/mesh.py, parallel/sfinder.py).
The serving export (deploy.py) traces `make_tile_step`'s step.

`recorder` (utils/trace.py) is the span recorder of the run driving the
engine, set by that run (the SFinder) for its duration: staging is the
span `engine.stage` (child `engine.pin`), each dispatched batch the span
`engine.dispatch` (child `engine.origins`) with its device events.
"""

from __future__ import annotations

import numpy as np
import torch

from caesar_yolo_tpu_torch.detect.nms import DEFAULT_PRE_NMS
from caesar_yolo_tpu_torch.detect.predictor import detect_images, prepare_model
from caesar_yolo_tpu_torch.models.yolo import YOLO
from caesar_yolo_tpu_torch.ops.transforms import prepare_tiles
from caesar_yolo_tpu_torch.utils.device import resolve_device
from caesar_yolo_tpu_torch.utils.trace import NULL


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
        self.recorder = NULL
        self.relay_dtype = (torch.bfloat16
                            if str(relay_dtype) in ("bfloat16", "bf16")
                            else torch.float32)
        self._fuse = fuse
        self.compute_dtype = compute_dtype
        self.preprocessor = preprocessor
        self._step_kwargs = dict(
            img_size=img_size, score_thr=score_thr, iou_thr=iou_thr,
            max_det=max_det, pre_nms=pre_nms)
        self.update_params(model)

    def update_params(self, model: YOLO) -> None:
        """Swap in the weights `model` carries (e.g. a trainer's EMA model,
        for validation during training) with the same treatment as at
        construction: prepare_model copies it, folds BatchNorm and casts,
        so the caller's modules are never changed."""
        self.model = prepare_model(model, fuse=self._fuse,
                                   dtype=self.compute_dtype,
                                   device=self.device)
        # the step of raw tiles, and of tiles cut from a mosaic that
        # preprocess_mosaic has already preprocessed (gray -> 3 channels and
        # the degenerate-channel guard only)
        self._step = make_tile_step(self.model, preprocessor=self.preprocessor,
                                    **self._step_kwargs)
        self._step_preprocessed = make_tile_step(
            self.model, preprocessor=None, **self._step_kwargs)

    def put_tiles(self, tiles: np.ndarray) -> torch.Tensor:
        """Stage a host tile batch on the device in the relay dtype
        (pinned and asynchronous on CUDA)."""
        with self.recorder.span("engine.stage"):
            t = torch.from_numpy(np.ascontiguousarray(tiles, np.float32))
            t = t.to(self.relay_dtype)
            if self.device.type == "cuda":
                with self.recorder.span("engine.pin"):
                    t = t.pin_memory()
            return t.to(self.device, non_blocking=True)

    @torch.inference_mode()
    def process_async(self, tiles, batch: int | None = None):
        """Enqueue one batch without waiting for the device; returns
        device tensors.  Takes a host array or a staged tensor.  `batch`
        is the run's index of the batch (its spans and device events)."""
        with self.recorder.span("engine.dispatch", batch), \
                self.recorder.on_device(batch, self.device):
            if isinstance(tiles, np.ndarray):
                tiles = self.put_tiles(tiles)
            return self._step(tiles)

    def process(self, tiles):
        return tuple(t.cpu().numpy() for t in self.process_async(tiles))

    # -- device-resident mosaic tiling ---------------------------------------

    def put_mosaic(self, mosaic: np.ndarray) -> torch.Tensor:
        """Ship a mosaic (or a full-width band of one) [H, W] to the device
        once, in the relay dtype, pinned and asynchronous on CUDA: windows
        are then cut on the device, so no overlap pixel crosses the link
        twice."""
        return self.put_tiles(mosaic)

    @torch.inference_mode()
    def preprocess_mosaic(self, mosaic_dev: torch.Tensor):
        """The pipeline run once over the whole device-resident mosaic (the
        global statistics context) -> (f32 [H, W], whether it is valid).
        As the reference (engine.py:220-252) it runs on the mosaic as one
        gray plane [1, H, W, 1] and keeps channel 0 of the result."""
        if self.preprocessor is None:
            return mosaic_dev, True
        out, ok = self.preprocessor.apply_batch(
            mosaic_dev.float()[None, :, :, None])
        return out[0, :, :, 0].contiguous(), bool(ok[0])

    @torch.inference_mode()
    def process_mosaic_async(self, mosaic_dev: torch.Tensor,
                             origins: np.ndarray, tile_shape: tuple[int, int],
                             preprocessed: bool = False,
                             batch: int | None = None):
        """Detect a batch of windows cut from a device-resident mosaic
        [H, W]: origins [B, 2] (row, column) of each window's corner, all of
        shape tile_shape = (h, w) (padding slots take (0, 0)).  Same outputs
        as process_async.  preprocessed=True: the mosaic went through
        preprocess_mosaic, so only gray -> 3 channels and the
        degenerate-channel guard run on the windows.  `batch` as in
        process_async."""
        h, w = tile_shape
        dev = mosaic_dev.device
        with self.recorder.span("engine.dispatch", batch), \
                self.recorder.on_device(batch, dev):
            origins = np.asarray(origins, np.int64).reshape(-1, 2)
            H, W = mosaic_dev.shape
            if (origins < 0).any() or (origins[:, 0] + h > H).any() or (
                    origins[:, 1] + w > W).any():
                raise ValueError(f"windows {tile_shape} at "
                                 f"{origins.tolist()} leave the mosaic "
                                 f"{(H, W)}")
            with self.recorder.span("engine.origins"):
                o = torch.from_numpy(origins).to(dev)
            rows = o[:, :1] + torch.arange(h, device=dev)          # [B, h]
            cols = o[:, 1:] + torch.arange(w, device=dev)          # [B, w]
            tiles = mosaic_dev[rows[:, :, None], cols[:, None, :]]  # 1 gather
            step = self._step_preprocessed if preprocessed else self._step
            return step(tiles[..., None])
