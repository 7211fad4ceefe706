"""Graph-based post-NMS detection merging (host side).

A copy of caesar_yolo_tpu/detect/merge.py: the port may not import the JAX
package, not even its host-only modules.

Re-implements the reference's second dedup pass on top of NMS
(reference evaluation.py:252-346): two boxes are mergeable when
IoU >= hard_thr, or when they share a class and IoU >= soft_thr; per
connected component only the highest-score box survives.  N here is the
per-image detection count (tiny), so this runs vectorized numpy on host
— union-find instead of the reference's recursive DFS.
"""

from __future__ import annotations

import numpy as np

from caesar_yolo_tpu_torch.utils.boxes import iou_matrix_np
from caesar_yolo_tpu_torch.utils.unionfind import connected_components


def merge_detections(boxes: np.ndarray, scores: np.ndarray,
                     class_ids: np.ndarray,
                     soft_thr: float = 0.3, hard_thr: float = 0.8):
    """Merge overlapping detections of one image.

    boxes [N,4] xyxy, scores [N], class_ids [N] -> (boxes, scores,
    class_ids) of the surviving representatives, kept in component order
    (component of the lowest original index first — the reference's
    ordering).  Ties on score keep the lowest index (strict '>' scan,
    reference evaluation.py:322-330).
    """
    boxes = np.asarray(boxes, dtype=np.float64).reshape(-1, 4)
    scores = np.asarray(scores, dtype=np.float64).reshape(-1)
    class_ids = np.asarray(class_ids).reshape(-1)
    n = boxes.shape[0]
    if n == 0:
        return boxes, scores, class_ids

    iou = iou_matrix_np(boxes, boxes)
    same_class = class_ids[:, None] == class_ids[None, :]
    mergeable = (iou >= hard_thr) | (same_class & (iou >= soft_thr))
    np.fill_diagonal(mergeable, False)

    keep = []
    for comp in connected_components(n, mergeable):
        comp = np.asarray(comp)
        best = comp[int(np.argmax(scores[comp]))]  # first max = lowest index
        keep.append(best)
    keep = np.asarray(keep, dtype=np.int64)
    return boxes[keep], scores[keep], class_ids[keep]
