"""Per-image detection orchestration (the reference's Analyzer).

Counterpart of caesar_yolo_tpu/detect/analyzer.py: gray -> 3 channels,
preprocessing, the degenerate-channel guard, prediction, the graph-based
overlap merge, and the output fan-out: the JSON catalog, DS9 regions, the
preprocessed image's first channel as FITS (`save_img`) and the detection
plot (`draw`: saved with `save_plot`, else shown; outputs/plot.py,
matplotlib imported only then).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from caesar_yolo_tpu_torch import logger
from caesar_yolo_tpu_torch.detect.merge import merge_detections
from caesar_yolo_tpu_torch.detect.predictor import Predictor
from caesar_yolo_tpu_torch.ops.transforms import prepare_tiles
from caesar_yolo_tpu_torch.outputs.catalog import (
    CLASS_NAMES,
    make_json_results,
    make_objects,
    write_json,
)
from caesar_yolo_tpu_torch.outputs.ds9 import write_ds9_regions
from caesar_yolo_tpu_torch.utils.fits import write_fits


@dataclass
class AnalyzerOutputs:
    """Per-image output toggles and paths (reference CONFIG keys)."""
    write_json: bool = True
    write_ds9: bool = True
    save_img: bool = False
    draw: bool = False
    save_plot: bool = False
    draw_class_label_in_caption: bool = True
    outfile_json: str = ""
    outfile_ds9: str = ""
    outfile_img: str = ""
    outfile_plot: str = ""


@dataclass
class Detections:
    """Final per-image detections, local image coords."""
    boxes: np.ndarray = field(default_factory=lambda: np.zeros((0, 4)))
    scores: np.ndarray = field(default_factory=lambda: np.zeros((0,)))
    class_ids: np.ndarray = field(
        default_factory=lambda: np.zeros((0,), np.int64))

    def __len__(self):
        return len(self.scores)


class Analyzer:
    """Single-image detection engine.

    predict(image, image_id, xmin=0, ymin=0) runs preprocess -> detector
    -> merge -> outputs; results land in `self.detections` and
    `self.results` (the catalog dict)."""

    def __init__(self, predictor: Predictor, *, preprocessor=None,
                 soft_merge_thr: float = 0.3, hard_merge_thr: float = 0.8,
                 outputs: AnalyzerOutputs | None = None,
                 class_names=CLASS_NAMES, obj_name_tag: str = ""):
        self.predictor = predictor
        self.preprocessor = preprocessor
        self.soft_merge_thr = soft_merge_thr
        self.hard_merge_thr = hard_merge_thr
        self.outputs = outputs or AnalyzerOutputs()
        self.class_names = class_names
        self.obj_name_tag = obj_name_tag
        self.detections = Detections()
        self.results: dict = {}
        self.image = None

    @torch.inference_mode()
    def prepare_image(self, image) -> torch.Tensor | None:
        """Replicate gray to the model's channel count, preprocess, and
        apply the degenerate-channel guard.  Returns the image [H, W, C]
        on the predictor's device, or None when it cannot be predicted
        on (the reference's no-prediction paths)."""
        img = torch.as_tensor(np.asarray(image, dtype=np.float32),
                              device=self.predictor.device)
        if img.ndim == 2:
            img = img[:, :, None]
        imgs, ok = prepare_tiles(img[None], self.preprocessor,
                                 self.predictor.in_channels)
        if not bool(ok[0]):
            logger.warning("Image is invalid after preprocessing or has a "
                           "degenerate channel, skipping prediction")
            return None
        return imgs[0]

    def predict(self, image, image_id="", *, xmin: float = 0,
                ymin: float = 0) -> int:
        """Full per-image pipeline.  Returns 0 on success, -1 when the
        image was skipped (degenerate or invalid)."""
        img = self.prepare_image(image)
        if img is None:
            self.detections = Detections()
            self.results = make_json_results(image_id, [])
            return -1
        self.image = img

        boxes, scores, class_ids = self.predictor.predict_image(img)
        boxes, scores, class_ids = merge_detections(
            boxes, scores, class_ids,
            soft_thr=self.soft_merge_thr, hard_thr=self.hard_merge_thr)
        self.detections = Detections(boxes, scores, class_ids)
        objs = make_objects(boxes, scores, class_ids,
                            image_shape=tuple(img.shape), xmin=xmin,
                            ymin=ymin, name_tag=self.obj_name_tag,
                            class_names=self.class_names)
        self.results = make_json_results(image_id, objs)
        self._write_outputs(image_id, objs)
        return 0

    def _write_outputs(self, image_id, objs):
        o = self.outputs
        if o.write_json:
            write_json(self.results, o.outfile_json or f"out_{image_id}.json")
        if o.write_ds9:
            write_ds9_regions(objs, o.outfile_ds9 or f"out_{image_id}.reg")
        if not (o.save_img or o.draw) or self.image is None:
            return
        image = self.image.float().cpu().numpy()
        if o.save_img:
            write_fits(image[:, :, 0], o.outfile_img or f"out_{image_id}.fits")
        if o.draw:
            from caesar_yolo_tpu_torch.outputs.plot import draw_results
            # plot in LOCAL image coords (objs carry the mosaic offset)
            d = self.detections
            local = [{**obj, "x1": d.boxes[i][0], "y1": d.boxes[i][1],
                      "x2": d.boxes[i][2], "y2": d.boxes[i][3]}
                     for i, obj in enumerate(objs)]
            draw_results(image, local,
                         o.outfile_plot or f"out_{image_id}.png",
                         draw_class_label_in_caption=(
                             o.draw_class_label_in_caption),
                         show=not o.save_plot)
