"""Bounding-box math: pairwise IoU (torch, for NMS) and its numpy twin
(host-side merge), the IoU of two boxes, enclosing boxes and the
xywh/xyxy conversions.  Counterpart of caesar_yolo_tpu/utils/boxes.py."""

from __future__ import annotations

import numpy as np
import torch


def get_iou(bb1, bb2) -> float:
    """IoU of two xyxy boxes (semantics of reference utils.py:54-107), in
    float64 on the host.  Degenerate boxes (x1 >= x2 or y1 >= y2) yield 0
    instead of asserting."""
    m = iou_matrix_np(np.asarray(bb1, dtype=np.float64)[None, :],
                      np.asarray(bb2, dtype=np.float64)[None, :])
    return float(m[0, 0])


def iou_matrix(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU [..., N, M] of xyxy boxes [..., N, 4] and [..., M, 4],
    in the f32 op order of the reference (boxes.py:41-51)."""
    b1 = boxes1[..., :, None, :]
    b2 = boxes2[..., None, :, :]
    iw = (torch.minimum(b1[..., 2], b2[..., 2])
          - torch.maximum(b1[..., 0], b2[..., 0]))
    ih = (torch.minimum(b1[..., 3], b2[..., 3])
          - torch.maximum(b1[..., 1], b2[..., 1]))
    inter = iw.clamp(min=0) * ih.clamp(min=0)
    a1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    a2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    union = a1 + a2 - inter
    pos = union > 0
    return torch.where(pos, inter / torch.where(pos, union, 1.0), 0.0)


def iou_matrix_np(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """Pairwise IoU matrix [N, M] for xyxy boxes (numpy, float64)."""
    boxes1 = np.asarray(boxes1, dtype=np.float64)
    boxes2 = np.asarray(boxes2, dtype=np.float64)
    x11, y11, x12, y12 = [boxes1[:, i][:, None] for i in range(4)]
    x21, y21, x22, y22 = [boxes2[:, i][None, :] for i in range(4)]
    iw = np.minimum(x12, x22) - np.maximum(x11, x21)
    ih = np.minimum(y12, y22) - np.maximum(y11, y21)
    # touching boxes (zero width) intersect with area 0 -> IoU 0
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    a1 = np.clip(x12 - x11, 0, None) * np.clip(y12 - y11, 0, None)
    a2 = np.clip(x22 - x21, 0, None) * np.clip(y22 - y21, 0, None)
    union = a1 + a2 - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1.0), 0.0)


def get_merged_bbox(bboxes) -> tuple:
    """Enclosing box of a list of xyxy boxes (reference utils.py:110-119)."""
    x = np.asarray(bboxes)
    return (x[:, 0].min(), x[:, 1].min(), x[:, 2].max(), x[:, 3].max())


def boxes_overlap_np(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """Pairwise closed-interval overlap predicate [N,M].

    Matches the reference's stitch-time check (inference.py:796-801):
    boxes sharing only an edge/corner DO overlap (<=/>= comparisons).
    """
    boxes1 = np.asarray(boxes1, dtype=np.float64)
    boxes2 = np.asarray(boxes2, dtype=np.float64)
    not_olap = (
        (boxes1[:, None, 2] < boxes2[None, :, 0])
        | (boxes1[:, None, 0] > boxes2[None, :, 2])
        | (boxes1[:, None, 3] < boxes2[None, :, 1])
        | (boxes1[:, None, 1] > boxes2[None, :, 3])
    )
    return ~not_olap


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """Convert (cx, cy, w, h) -> (x1, y1, x2, y2) along the last axis."""
    cx, cy, w, h = x.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def xyxy2xywh(x: torch.Tensor) -> torch.Tensor:
    """Convert (x1, y1, x2, y2) -> (cx, cy, w, h) along the last axis."""
    x1, y1, x2, y2 = x.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1],
                       dim=-1)


def catalog_mismatch(ref, got, iou_min: float = 0.99,
                     score_tol: float = 1e-3) -> str | None:
    """The catalog rule of the port's parity checks: `ref` and `got` are
    (boxes[N, 4], scores[N], class_ids[N], *flags) of one image or
    mosaic; they match when the counts are equal and every reference
    detection has its own partner with IoU >= iou_min, the same class, a
    score within score_tol and equal flags (e.g. a stitched catalog's
    edge and merged flags), as a set: near-equal scores may come out in
    another order.  Returns None on a match, else what differs."""
    rb, rs, rc, *rf = (np.asarray(a) for a in ref)
    gb, gs, gc, *gf = (np.asarray(a) for a in got)
    if len(rs) != len(gs):
        return f"count {len(gs)} != reference {len(rs)}"
    used = np.zeros(len(gs), bool)
    for i in range(len(rs)):
        iou = iou_matrix_np(rb[i:i + 1].reshape(1, 4),
                            gb.reshape(-1, 4))[0]
        cand = ((iou >= iou_min) & (gc == rc[i])
                & (np.abs(gs - rs[i]) <= score_tol) & ~used)
        for r, g in zip(rf, gf):
            cand &= g == r[i]
        if not cand.any():
            return (f"reference detection {i} (box {rb[i]}, score "
                    f"{float(rs[i]):.4f}, class {int(rc[i])}) has no "
                    f"partner (best IoU {iou.max(initial=0.0):.4f})")
        used[int(np.argmax(cand))] = True
    return None
