"""YOLOv8/YOLO11 detection loss.

Counterpart of caesar_yolo_tpu/train/loss.py: task-aligned assignment
(align = score^alpha * CIoU^beta, top-k candidates per gt), BCE
classification against soft target scores, CIoU box loss and
distribution-focal box regression, with gt boxes padded to a fixed count
and masked.  All loss math runs in f32, and the assigner's inputs and
outputs are detached where the reference stops gradients.  Under a process
group each rank passes its shard of the global batch: the target-score sum
and the batch size are the global batch's (summed over the ranks, without
gradient), so the ranks' losses add up to the global batch's, as the
reference's loss over its sharded global array (loss.py:212-227).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from caesar_yolo_tpu_torch.models.yolo import REG_MAX, _device_anchor_points
from caesar_yolo_tpu_torch.models.yolo import flatten_raw as _yolo_flatten_raw
from caesar_yolo_tpu_torch.parallel import mesh


def ciou(box1: torch.Tensor, box2: torch.Tensor, eps: float = 1e-7):
    """Complete IoU of xyxy boxes (broadcasting elementwise on [..., 4]);
    the aspect term's alpha carries no gradient."""
    x11, y11, x12, y12 = box1.unbind(-1)
    x21, y21, x22, y22 = box2.unbind(-1)
    w1, h1 = x12 - x11, y12 - y11
    w2, h2 = x22 - x21, y22 - y21
    iw = (torch.minimum(x12, x22) - torch.maximum(x11, x21)).clamp(min=0)
    ih = (torch.minimum(y12, y22) - torch.maximum(y11, y21)).clamp(min=0)
    inter = iw * ih
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    cw = torch.maximum(x12, x22) - torch.minimum(x11, x21)
    ch = torch.maximum(y12, y22) - torch.minimum(y11, y21)
    c2 = cw * cw + ch * ch + eps
    rho2 = ((x21 + x22 - x11 - x12) ** 2 + (y21 + y22 - y11 - y12) ** 2) / 4
    v = (4 / math.pi ** 2) * (torch.atan(w2 / (h2 + eps))
                              - torch.atan(w1 / (h1 + eps))) ** 2
    alpha = (v / (v - iou + (1 + eps))).detach()
    return iou - (rho2 / c2 + v * alpha)


def dist2bbox(ltrb: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """(l, t, r, b) distances + anchor centres -> xyxy (same units)."""
    return torch.cat([anchors - ltrb[..., :2], anchors + ltrb[..., 2:]],
                     dim=-1)


def bbox2dist(bbox: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """xyxy -> (l, t, r, b) clamped to the DFL support [0, REG_MAX-1)."""
    lt = anchors - bbox[..., :2]
    rb = bbox[..., 2:] - anchors
    return torch.cat([lt, rb], dim=-1).clamp(0, REG_MAX - 1 - 0.01)


def dfl_loss(pred_dist: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Distribution focal loss: pred_dist [..., 4, REG_MAX] logits, target
    [..., 4] distances in [0, REG_MAX-1) -> [...] (mean over the sides).
    The two-bin cross-entropy as a one-hot weighted sum over the bins, as
    the reference."""
    tl = torch.floor(target).long()
    tr = tl + 1
    wl = tr.to(target.dtype) - target
    wr = 1.0 - wl
    logp = torch.log_softmax(pred_dist, dim=-1)
    w = (wl[..., None] * F.one_hot(tl, REG_MAX).to(logp.dtype)
         + wr[..., None] * F.one_hot(tr, REG_MAX).to(logp.dtype))
    return -(logp * w).sum(dim=-1).mean(dim=-1)


@torch.no_grad()
def task_aligned_assigner(pd_scores, pd_bboxes, anchors, gt_labels,
                          gt_bboxes, mask_gt, *, topk: int = 10,
                          alpha: float = 0.5, beta: float = 6.0,
                          eps: float = 1e-9):
    """Task-aligned one-to-many assignment (fixed shapes).

    pd_scores [B, A, NC] (post-sigmoid), pd_bboxes [B, A, 4] px,
    anchors [A, 2] px, gt_labels [B, M] int, gt_bboxes [B, M, 4] px,
    mask_gt [B, M] bool.  Returns (target_labels [B, A], target_bboxes
    [B, A, 4], target_scores [B, A, NC], fg_mask [B, A]).  The one-hot
    contractions of the reference are gathers here (each selects one
    value exactly).
    """
    b, a, nc = pd_scores.shape
    m = gt_bboxes.shape[1]
    mask_gt = mask_gt.bool()

    deltas_lt = anchors[None, None] - gt_bboxes[:, :, None, :2]
    deltas_rb = gt_bboxes[:, :, None, 2:] - anchors[None, None]
    mask_in_gts = torch.cat([deltas_lt, deltas_rb],
                            dim=-1).amin(dim=-1) > eps          # [B, M, A]

    overlaps = ciou(gt_bboxes[:, :, None, :],
                    pd_bboxes[:, None, :, :]).clamp(min=0)      # [B, M, A]
    lbl = gt_labels.long().clamp(0, nc - 1)                    # [B, M]
    bbox_scores = torch.gather(pd_scores.transpose(1, 2), 1,
                               lbl[:, :, None].expand(b, m, a))

    align = bbox_scores ** alpha * overlaps ** beta
    valid = mask_in_gts & mask_gt[:, :, None]
    align_masked = torch.where(valid, align, torch.zeros_like(align))

    # k max-mask rounds (the reference's fori_loop, loss.py:134-146): the
    # k-th value, with exact ties masked together in one round, which can
    # only widen the >= kth selection -- not torch.topk
    cur = align_masked
    kth = torch.full(align_masked.shape[:-1] + (1,), math.inf,
                     dtype=align_masked.dtype, device=align_masked.device)
    neg_inf = torch.tensor(-math.inf, dtype=cur.dtype, device=cur.device)
    for _ in range(min(topk, a)):
        kth = cur.amax(dim=-1, keepdim=True)
        cur = torch.where(cur >= kth, neg_inf, cur)
    mask_pos = (align_masked >= kth) & (align_masked > eps) & valid

    # resolve multi-gt anchors: keep the gt of largest overlap; argmax
    # returns the first maximum, as jnp.argmax
    fg_counts = mask_pos.sum(dim=1)                             # [B, A]
    conflict = fg_counts > 1
    max_overlap_gt = torch.where(mask_pos, overlaps,
                                 torch.full_like(overlaps, -1.0)).argmax(1)
    assigned_gt = mask_pos.to(torch.int32).argmax(dim=1)
    target_gt_idx = torch.where(conflict, max_overlap_gt, assigned_gt)
    fg_mask = fg_counts > 0
    sel = F.one_hot(target_gt_idx, m).bool().transpose(1, 2)  # [B, M, A]
    mask_pos = sel & mask_pos

    target_labels = torch.gather(lbl, 1, target_gt_idx)        # [B, A]
    target_bboxes = torch.gather(
        gt_bboxes, 1, target_gt_idx[..., None].expand(b, a, 4))

    zero = torch.zeros((), dtype=align.dtype, device=align.device)
    align_pos = torch.where(mask_pos, align, zero)
    pos_align = align_pos.amax(dim=-1, keepdim=True)            # [B, M, 1]
    pos_overlap = torch.where(mask_pos, overlaps, zero).amax(
        dim=-1, keepdim=True)
    norm = (align_pos * pos_overlap / (pos_align + eps)).amax(dim=1)
    onehot = F.one_hot(target_labels, nc).to(pd_scores.dtype)
    target_scores = onehot * (norm * fg_mask)[..., None]
    return target_labels, target_bboxes, target_scores, fg_mask


def flatten_raw(raw):
    """Per-level (box, cls) head maps -> (pred_dist [B, A, 4, REG_MAX],
    pred_logits [B, A, NC]) in f32, whatever the forward's dtype."""
    dist, logits = _yolo_flatten_raw(raw)
    return dist.float(), logits.float()


def sigmoid_bce(logits, targets):
    """Elementwise sigmoid binary cross-entropy (stable form)."""
    return (logits.clamp(min=0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def detection_loss(raw, gt_labels, gt_bboxes, mask_gt, *, img_size: int,
                   box_gain: float = 7.5, cls_gain: float = 0.5,
                   dfl_gain: float = 1.5, topk: int = 10):
    """Total detection loss for a batch (under a process group, this
    rank's share of the global batch's).

    raw: the model's output; gt_labels [B, M] int; gt_bboxes [B, M, 4]
    xyxy in input-image pixels; mask_gt [B, M] bool.  Returns
    (total_loss, {"box", "cls", "dfl"} unscaled components)."""
    pred_dist, pred_logits = flatten_raw(raw)
    b = pred_logits.shape[0]
    dev = pred_logits.device
    anchors, strides = _device_anchor_points(img_size, dev)
    gt_bboxes = gt_bboxes.to(dev, torch.float32)

    prob = torch.softmax(pred_dist, dim=-1)
    bins = torch.arange(REG_MAX, dtype=torch.float32, device=dev)
    ltrb = (prob * bins).sum(dim=-1)
    pred_bboxes = dist2bbox(ltrb, anchors[None])               # grid units

    _, target_bboxes, target_scores, fg_mask = task_aligned_assigner(
        torch.sigmoid(pred_logits).detach(),
        pred_bboxes.detach() * strides[None], anchors * strides,
        gt_labels.to(dev), gt_bboxes, mask_gt.to(dev), topk=topk)

    target_scores_sum = target_scores.sum()
    if mesh.distributed():
        target_scores_sum, b = mesh.all_reduce_sum(torch.stack([
            target_scores_sum.detach(),
            torch.tensor(float(b), device=dev)]))
    target_scores_sum = target_scores_sum.clamp(min=1.0)
    loss_cls = sigmoid_bce(pred_logits, target_scores).sum() \
        / target_scores_sum

    tb = target_bboxes / strides[None]
    weight = target_scores.sum(-1) * fg_mask
    iou_term = 1.0 - ciou(pred_bboxes, tb)
    loss_box = (iou_term * weight).sum() / target_scores_sum
    tdist = bbox2dist(tb, anchors[None])
    loss_dfl = (dfl_loss(pred_dist, tdist) * weight).sum() / target_scores_sum

    total = (box_gain * loss_box + cls_gain * loss_cls
             + dfl_gain * loss_dfl) * b
    return total, {"box": loss_box, "cls": loss_cls, "dfl": loss_dfl}
