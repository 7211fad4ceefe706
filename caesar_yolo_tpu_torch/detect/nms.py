"""Fixed-shape batched greedy NMS.

Counterpart of caesar_yolo_tpu/detect/nms.py:nms_batch, with its
contract: single-label candidates (class = argmax, conf = max, strict
conf > conf_thr, non-candidates filled with -1.0), a score-descending
window of the top `pre_nms` (ties keep the lower anchor index first, as
lax.top_k), `n_dropped` counting the above-threshold candidates outside
that window, class-aware suppression through MAX_WH class offsets with
strict iou > iou_thr, and compaction to `max_det` rows in score order
with dead rows zeroed (the reference's `scatter1` formulation).

Suppression runs in kernel K1 on CUDA tensors (detect/cuda_nms.py);
selection and compaction are plain PyTorch around it.  `nms_single` is
the one-image form, and `nms_batch_raw` the reference's fused decode +
NMS (selection on the raw logits, the DFL decoded on the window only):
not the default path, kept as the reference keeps it.
"""

from __future__ import annotations

import math

import torch

from caesar_yolo_tpu_torch.detect.cuda_nms import nms_suppress

MAX_WH = 7680.0  # class offset multiplier (larger than any letterbox size)
DEFAULT_PRE_NMS = 512


def _select_candidates(boxes, scores, conf_thr, pre_nms, class_agnostic):
    """Single-label selection + score-descending top-k window, batched."""
    conf, cls = scores.max(dim=-1)
    cls = cls.to(torch.int32)
    cand = conf > conf_thr
    k = min(pre_nms, boxes.shape[1])
    n_dropped = (cand.sum(dim=1, dtype=torch.int32) - k).clamp(min=0)
    # a stable descending sort puts equal scores in index order, as
    # lax.top_k does; torch.topk promises no order on ties
    masked = torch.where(cand, conf, -1.0)
    top_conf, top_idx = torch.sort(masked, dim=1, descending=True,
                                   stable=True)
    top_conf, top_idx = top_conf[:, :k], top_idx[:, :k]
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    top_cls = torch.gather(cls, 1, top_idx)
    top_valid = top_conf > conf_thr
    nms_boxes = top_boxes
    if not class_agnostic:
        nms_boxes = top_boxes + top_cls[..., None].to(top_boxes.dtype) * MAX_WH
    return top_boxes, top_conf, top_cls, top_valid, n_dropped, nms_boxes


def _compact(top_boxes, top_conf, top_cls, alive, max_det):
    """Kept rows -> fixed [B, max_det] outputs in score order, dead rows
    zero: one scatter of packed [K, 8] f32 rows by rank, with dead or
    overflowing rows sent to the discard slot `max_det`."""
    b, k = alive.shape
    rank = torch.cumsum(alive.to(torch.int64), dim=1) - 1
    dst = torch.where(alive & (rank < max_det), rank, max_det)
    packed = torch.cat([
        top_boxes.float(), top_conf[..., None].float(),
        top_cls[..., None].float(), alive[..., None].float(),
        torch.zeros((b, k, 1), dtype=torch.float32, device=alive.device)],
        dim=2)
    out = torch.zeros((b, max_det + 1, 8), dtype=torch.float32,
                      device=alive.device)
    out.scatter_(1, dst[..., None].expand(-1, -1, 8), packed)
    out = out[:, :max_det]
    return (out[..., :4].to(top_boxes.dtype), out[..., 4].to(top_conf.dtype),
            out[..., 5].to(torch.int32), out[..., 6] > 0)


def nms_batch(boxes: torch.Tensor, scores: torch.Tensor,
              conf_thr: float = 0.25, iou_thr: float = 0.5,
              max_det: int = 300, pre_nms: int = DEFAULT_PRE_NMS,
              class_agnostic: bool = False):
    """Batched NMS: boxes [B, A, 4], scores [B, A, NC] ->
    (boxes[B, max_det, 4], scores[B, max_det], cls[B, max_det] int32,
    valid[B, max_det] bool, n_dropped[B] int32)."""
    top_boxes, top_conf, top_cls, top_valid, n_dropped, nms_boxes = \
        _select_candidates(boxes, scores, conf_thr, pre_nms, class_agnostic)
    alive = nms_suppress(nms_boxes.transpose(1, 2), top_valid, iou_thr)
    return (*_compact(top_boxes, top_conf, top_cls, alive, max_det),
            n_dropped)


def nms_single(boxes: torch.Tensor, scores: torch.Tensor,
               conf_thr: float = 0.25, iou_thr: float = 0.5,
               max_det: int = 300, pre_nms: int = DEFAULT_PRE_NMS,
               class_agnostic: bool = False):
    """NMS for one image: boxes [A, 4] xyxy, scores [A, NC] ->
    (boxes[max_det, 4], scores[max_det], cls[max_det] int32,
    valid[max_det] bool, n_dropped int32 scalar), score-descending (the
    reference's nms_single, nms.py:63-81)."""
    out = nms_batch(boxes[None], scores[None], conf_thr=conf_thr,
                    iou_thr=iou_thr, max_det=max_det, pre_nms=pre_nms,
                    class_agnostic=class_agnostic)
    return tuple(t[0] for t in out)


def _logit_threshold(conf_thr: float) -> float:
    """The logit above which sigmoid(logit) > conf_thr."""
    if conf_thr <= 0.0:
        return -math.inf         # sigmoid(x) > 0 always
    if conf_thr >= 1.0:
        return math.inf
    return math.log(conf_thr / (1.0 - conf_thr))


def _select_candidates_raw(dist, logits, anchors, strides, conf_thr,
                           pre_nms, class_agnostic):
    """Logit-space selection and the DFL decode of the window only
    (reference nms.py:_select_candidates_raw): dist [B, A, 4, REG_MAX] and
    logits [B, A, NC] raw -> as `_select_candidates`.  Sigmoid is
    monotone, so max, argmax, threshold and the window run on the logits;
    only score ties that exist after the f32 sigmoid but not before
    (|logit| past ~17) may order differently."""
    from caesar_yolo_tpu_torch.models.yolo import decode_dfl_window
    mlog = logits.amax(dim=-1).float()
    cls = torch.argmax(logits, dim=-1).to(torch.int32)
    lthr = _logit_threshold(conf_thr)
    cand = mlog > lthr
    k = min(pre_nms, mlog.shape[1])
    n_dropped = (cand.sum(dim=1, dtype=torch.int32) - k).clamp(min=0)
    top_ml, top_idx = torch.sort(torch.where(cand, mlog, -math.inf), dim=1,
                                 descending=True, stable=True)
    top_ml, top_idx = top_ml[:, :k], top_idx[:, :k]
    top_conf = torch.sigmoid(top_ml)
    top_cls = torch.gather(cls, 1, top_idx)
    top_valid = top_ml > lthr
    win = torch.gather(dist, 1, top_idx[..., None, None].expand(
        -1, -1, *dist.shape[2:]))
    top_boxes = decode_dfl_window(win, anchors[top_idx], strides[top_idx])
    nms_boxes = top_boxes
    if not class_agnostic:
        nms_boxes = top_boxes + top_cls[..., None].to(top_boxes.dtype) * MAX_WH
    return top_boxes, top_conf, top_cls, top_valid, n_dropped, nms_boxes


def nms_batch_raw(raw, img_size: int, conf_thr: float = 0.25,
                  iou_thr: float = 0.5, max_det: int = 300,
                  pre_nms: int = DEFAULT_PRE_NMS,
                  class_agnostic: bool = False):
    """Fused decode + NMS from the raw head outputs (per level (box [B,
    4*REG_MAX, h, w], cls [B, NC, h, w])): the contract of
    `nms_batch(*decode_dfl(raw, img_size), ...)` with the selection in
    logit space and the f32 DFL expectation taken on the pre_nms window
    only (reference nms.py:nms_batch_raw).  Not the default path: the
    reference measured it slower on its TPU (the window gathers cost more
    than the decode they save) and keeps it as a documented alternative;
    so does the port.  Suppression is K1 on CUDA tensors."""
    from caesar_yolo_tpu_torch.models.yolo import anchor_points, flatten_raw
    dist, logits = flatten_raw(raw)
    anchors, strides = anchor_points(img_size, device=dist.device)
    top_boxes, top_conf, top_cls, top_valid, n_dropped, nms_boxes = \
        _select_candidates_raw(dist, logits, anchors, strides, conf_thr,
                               pre_nms, class_agnostic)
    alive = nms_suppress(nms_boxes.transpose(1, 2), top_valid, iou_thr)
    return (*_compact(top_boxes, top_conf, top_cls, alive, max_det),
            n_dropped)
