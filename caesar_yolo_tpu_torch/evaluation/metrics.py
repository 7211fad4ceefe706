"""Dataset-level detection quality metrics: completeness / reliability / F1
and COCO-style mAP.

A numpy copy of caesar_yolo_tpu/evaluation/metrics.py (the port may not
import the JAX package), with its figure writers (`save_report_figure`,
`save_pr_figure`: cli.evaluate --save_plot), which import matplotlib
only when called.  Like the reference package it re-implements the reference evaluation macro's exact counting rules
(reference macros/make_prediction.py:328-441 completeness, :446-547
reliability; IoU >= 0.6 match criterion at :559,:633; F1 = 2CR/(C+R),
README.md:184-188):

  - "real source" classes: compact, extended, extended-multisland.
  - completeness: a gt real source counts as detected when SOME
    prediction matches with IoU >= thr AND the best-IoU match carries a
    real-source label (not necessarily the same class).  spurious and
    flagged gts count only when the best match has the SAME label.
  - reliability: a predicted real source counts when its best gt match
    (IoU >= thr) is a real source; spurious/flagged predictions count
    only on same-label matches.

The O(N*M) scalar loops of the reference are replaced by vectorized IoU
matrices per image.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from caesar_yolo_tpu_torch.utils.boxes import iou_matrix_np

SOURCE_CLASSES = ("compact", "extended", "extended-multisland")
SPECIAL_CLASSES = ("spurious", "flagged")


@dataclass
class ClassCounts:
    n: int = 0
    n_matched: int = 0

    @property
    def ratio(self) -> float:
        return self.n_matched / self.n if self.n > 0 else -999.0


@dataclass
class MetricsReport:
    completeness: dict = field(default_factory=dict)
    reliability: dict = field(default_factory=dict)
    f1: dict = field(default_factory=dict)
    map: "MAPReport | None" = None  # filled by evaluate_dataset

    def summary(self) -> str:
        lines = []
        for key in sorted(set(self.completeness) | set(self.reliability)):
            c = self.completeness.get(key)
            r = self.reliability.get(key)
            f = self.f1.get(key)
            lines.append(
                f"{key}: C={c.ratio if c else float('nan'):.4f} "
                f"(n={c.n if c else 0}) "
                f"R={r.ratio if r else float('nan'):.4f} "
                f"(n={r.n if r else 0}) "
                f"F1={f if f is not None else float('nan'):.4f}")
        return "\n".join(lines)


def _best_matches(boxes_a, boxes_b, iou_thr):
    """For each box in a: (matched?, best-match index in b)."""
    if len(boxes_a) == 0 or len(boxes_b) == 0:
        return (np.zeros(len(boxes_a), bool),
                np.full(len(boxes_a), -1, np.int64))
    iou = iou_matrix_np(np.asarray(boxes_a), np.asarray(boxes_b))
    matched = (iou >= iou_thr).any(axis=1)
    best = np.where(matched, np.argmax(np.where(iou >= iou_thr, iou, 0.0),
                                       axis=1), -1)
    return matched, best


def compute_completeness(gt_list, pred_list, iou_thr: float = 0.6) -> dict:
    """gt_list/pred_list: per-image dicts with 'bboxes' (xyxy) and
    'labels' (class-name strings).  Returns {key: ClassCounts} with keys
    'source' (cumulative real sources), each real class, 'spurious',
    'flagged'.

    Any class name not in SPECIAL_CLASSES counts as a real source class
    — custom datasets (names from dataset.yaml) score the same way the
    reference's radio classes do, instead of silently scoring zero."""
    counts = {k: ClassCounts() for k in
              ("source",) + SOURCE_CLASSES + SPECIAL_CLASSES}
    for gt, pred in zip(gt_list, pred_list):
        labels = list(gt["labels"])
        plabels = list(pred["labels"])
        matched, best = _best_matches(gt["bboxes"], pred["bboxes"], iou_thr)
        for j, label in enumerate(labels):
            det_label = plabels[best[j]] if matched[j] else "none"
            counts.setdefault(label, ClassCounts())
            if label in SPECIAL_CLASSES:
                counts[label].n += 1
                if matched[j] and det_label == label:
                    counts[label].n_matched += 1
            else:
                counts["source"].n += 1
                counts[label].n += 1
                if matched[j] and det_label != "none" \
                        and det_label not in SPECIAL_CLASSES:
                    counts["source"].n_matched += 1
                    counts[label].n_matched += 1
    return counts


def compute_reliability(gt_list, pred_list, iou_thr: float = 0.6) -> dict:
    """Mirror of compute_completeness over predictions."""
    counts = {k: ClassCounts() for k in
              ("source",) + SOURCE_CLASSES + SPECIAL_CLASSES}
    for gt, pred in zip(gt_list, pred_list):
        labels = list(gt["labels"])
        plabels = list(pred["labels"])
        matched, best = _best_matches(pred["bboxes"], gt["bboxes"], iou_thr)
        for j, plabel in enumerate(plabels):
            gt_label = labels[best[j]] if matched[j] else "none"
            counts.setdefault(plabel, ClassCounts())
            if plabel in SPECIAL_CLASSES:
                counts[plabel].n += 1
                if matched[j] and gt_label == plabel:
                    counts[plabel].n_matched += 1
            else:
                counts["source"].n += 1
                counts[plabel].n += 1
                if matched[j] and gt_label != "none" \
                        and gt_label not in SPECIAL_CLASSES:
                    counts["source"].n_matched += 1
                    counts[plabel].n_matched += 1
    return counts


def compute_metrics(gt_list, pred_list, iou_thr: float = 0.6) -> MetricsReport:
    """Full C/R/F1 report (F1 = 2CR/(C+R), README.md:184-188)."""
    comp = compute_completeness(gt_list, pred_list, iou_thr)
    rel = compute_reliability(gt_list, pred_list, iou_thr)
    f1 = {}
    for key in comp:
        c, r = comp[key].ratio, rel[key].ratio
        f1[key] = (2 * c * r / (c + r)
                   if c >= 0 and r >= 0 and (c + r) > 0 else float("nan"))
    return MetricsReport(completeness=comp, reliability=rel, f1=f1)


def _ap_from_curve(recall, precision) -> float:
    """Area under the precision envelope, 101-point interpolation (the
    COCO scheme ultralytics' compute_ap uses — the metric the reference's
    delegated trainer reports at validation, macros/run_train.py:20-45)."""
    # the closing zero-precision sentinel sits just PAST the last
    # achieved recall (not at 1.0), so a detector that reaches recall r
    # keeps its precision on [0, r] — and a perfect detector scores 1.0
    last = recall[-1] if len(recall) else 0.0
    mrec = np.concatenate(([0.0], recall, [last + 0.01]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0.0, 1.0, 101)
    # np.trapezoid is numpy>=2 only; np.trapz is its 1.x spelling
    trapz = getattr(np, "trapezoid", None) or np.trapz
    return float(trapz(np.interp(x, mrec, mpre), x))


def match_predictions(pred_boxes, pred_cls, gt_boxes, gt_cls, iou_thrs):
    """Per-image class-constrained greedy matching.

    Returns tp[N_pred, T] bool: prediction i is a true positive at IoU
    threshold t.  Matches are assigned in descending-IoU order with each
    gt and each prediction used at most once (ultralytics
    match_predictions semantics)."""
    n, t_count = len(pred_boxes), len(iou_thrs)
    tp = np.zeros((n, t_count), bool)
    if n == 0 or len(gt_boxes) == 0:
        return tp
    iou = iou_matrix_np(np.asarray(pred_boxes, np.float64),
                        np.asarray(gt_boxes, np.float64))
    same = np.asarray(pred_cls)[:, None] == np.asarray(gt_cls)[None, :]
    iou = np.where(same, iou, 0.0)
    for t, thr in enumerate(iou_thrs):
        cand = np.argwhere(iou >= thr)
        if cand.size == 0:
            continue
        order = np.argsort(-iou[cand[:, 0], cand[:, 1]])
        used_p = np.zeros(n, bool)
        used_g = np.zeros(len(gt_boxes), bool)
        for k in order:
            p, g = cand[k]
            if used_p[p] or used_g[g]:
                continue
            used_p[p] = used_g[g] = True
            tp[p, t] = True
    return tp


@dataclass
class MAPReport:
    """COCO-style average precision over IoU thresholds 0.50:0.95."""
    per_class_ap50: dict = field(default_factory=dict)
    per_class_ap: dict = field(default_factory=dict)     # mean over thrs
    map50: float = float("nan")
    map75: float = float("nan")
    map50_95: float = float("nan")
    # raw PR points at IoU=0.50 per class, in descending-confidence
    # order: {label: (recall[n], precision[n], conf[n])} — the PR_curve
    # artifact, with the score threshold that realizes each point
    pr_curves: dict = field(default_factory=dict)

    def best_thresholds(self) -> dict:
        """Per-class score threshold maximizing PR-F1 at IoU=0.50.

        The reference leaves --scoreThr to hand-tuning (scripts/
        run.py:91, default 0.7); since the PR sweep is already computed
        from ONE detector pass at a low threshold, the optimum is free:
        keeping predictions with score >= conf[i] yields exactly
        (recall[i], precision[i]).  Returns
        {label: (thr, f1, precision, recall)}."""
        best = {}
        for label, (rec, prec, conf) in self.pr_curves.items():
            if not len(rec):
                continue
            f1 = 2 * rec * prec / np.maximum(rec + prec, 1e-16)
            i = int(np.argmax(f1))
            best[label] = (float(conf[i]), float(f1[i]),
                           float(prec[i]), float(rec[i]))
        return best

    def summary(self) -> str:
        lines = [f"mAP50={self.map50:.4f} mAP75={self.map75:.4f} "
                 f"mAP50-95={self.map50_95:.4f}"]
        for k in sorted(self.per_class_ap):
            lines.append(f"  {k}: AP50={self.per_class_ap50[k]:.4f} "
                         f"AP50-95={self.per_class_ap[k]:.4f}")
        return "\n".join(lines)


def compute_map(gt_list, pred_list, iou_thrs=None) -> MAPReport:
    """Dataset mAP from the same per-image gt/pred dicts compute_metrics
    takes; predictions must carry 'scores'.  Classes are label strings;
    the means run over classes that appear in the ground truth
    (ultralytics convention — classes with gt but no predictions score
    AP=0, prediction-only classes don't dilute the mean)."""
    if iou_thrs is None:
        # linspace, NOT arange: arange's accumulated float steps land a
        # few ulps ABOVE nominal (0.75000000000000022), turning an
        # exact-0.75-IoU match into a FP at the 0.75 threshold;
        # ultralytics uses linspace(0.5, 0.95, 10)
        iou_thrs = np.linspace(0.50, 0.95, 10)
    iou_thrs = np.asarray(iou_thrs)

    tps, confs, pcls = [], [], []
    n_gt: dict[str, int] = {}
    for gt, pred in zip(gt_list, pred_list):
        for label in gt["labels"]:
            n_gt[label] = n_gt.get(label, 0) + 1
        npred = len(pred["bboxes"])
        if npred:
            tps.append(match_predictions(
                pred["bboxes"], list(pred["labels"]),
                gt["bboxes"], list(gt["labels"]), iou_thrs))
            confs.append(np.asarray(pred["scores"], np.float64))
            pcls.extend(pred["labels"])
    report = MAPReport()
    if not n_gt:
        return report
    tp = (np.concatenate(tps) if tps
          else np.zeros((0, len(iou_thrs)), bool))
    conf = np.concatenate(confs) if confs else np.zeros((0,))
    pcls = np.asarray(pcls, object)

    order = np.argsort(-conf)
    tp, pcls = tp[order], pcls[order]

    i75 = int(np.argmin(np.abs(iou_thrs - 0.75)))
    ap75 = []
    for label, total in n_gt.items():
        sel = pcls == label
        tpc = np.cumsum(tp[sel], axis=0)                   # [n_c, T]
        fpc = np.cumsum(~tp[sel], axis=0)
        recall = tpc / total
        precision = tpc / np.maximum(tpc + fpc, 1e-16)
        aps = np.asarray(
            [_ap_from_curve(recall[:, t], precision[:, t])
             if sel.any() else 0.0 for t in range(len(iou_thrs))])
        report.per_class_ap50[label] = float(aps[0])
        report.per_class_ap[label] = float(aps.mean())
        report.pr_curves[label] = (recall[:, 0].copy(),
                                   precision[:, 0].copy(),
                                   conf[order][sel].copy())
        ap75.append(float(aps[i75]))
    report.map50 = float(np.mean(list(report.per_class_ap50.values())))
    report.map50_95 = float(np.mean(list(report.per_class_ap.values())))
    report.map75 = float(np.mean(ap75))
    return report


def per_image_match_detail(keys, gt_list, pred_list,
                           iou_thr: float = 0.6) -> list[dict]:
    """Per-image matched/unmatched detail (the reference eval macro also
    emits per-image match info alongside the summary,
    make_prediction.py:328-547): for every gt and every prediction, its
    box, label, and match partner (or none)."""
    detail = []
    for key, gt, pred in zip(keys, gt_list, pred_list):
        g_matched, g_best = _best_matches(gt["bboxes"], pred["bboxes"],
                                          iou_thr)
        p_matched, p_best = _best_matches(pred["bboxes"], gt["bboxes"],
                                          iou_thr)
        scores = list(pred.get("scores", []))
        detail.append({
            "image": key,
            "n_gt": len(gt["labels"]),
            "n_pred": len(pred["labels"]),
            "gt": [{
                "bbox": [float(v) for v in gt["bboxes"][j]],
                "label": gt["labels"][j],
                "detected": bool(g_matched[j]),
                "pred_index": int(g_best[j]),
                "pred_label": (pred["labels"][g_best[j]]
                               if g_matched[j] else "none"),
            } for j in range(len(gt["labels"]))],
            "pred": [{
                "bbox": [float(v) for v in pred["bboxes"][j]],
                "label": pred["labels"][j],
                "score": float(scores[j]) if j < len(scores) else -1.0,
                "matched": bool(p_matched[j]),
                "gt_index": int(p_best[j]),
            } for j in range(len(pred["labels"]))],
        })
    return detail


def save_report_figure(report: MetricsReport, path: str):
    """Per-class C/R/F1 bar figure (the reference macro's plot artifacts,
    make_prediction.py figures)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    keys = [k for k in sorted(set(report.completeness))
            if report.completeness[k].n > 0 or report.reliability[k].n > 0]
    c = [max(report.completeness[k].ratio, 0.0) for k in keys]
    r = [max(report.reliability[k].ratio, 0.0) for k in keys]
    f = [report.f1.get(k) for k in keys]
    f = [v if v is not None and np.isfinite(v) else 0.0 for v in f]
    x = np.arange(len(keys))
    fig, ax = plt.subplots(figsize=(1.8 * max(len(keys), 3), 4))
    ax.bar(x - 0.25, c, width=0.25, label="completeness")
    ax.bar(x, r, width=0.25, label="reliability")
    ax.bar(x + 0.25, f, width=0.25, label="F1")
    ax.set_xticks(x)
    ax.set_xticklabels(keys, rotation=20, ha="right")
    ax.set_ylim(0, 1.05)
    ax.legend()
    ax.set_title("Detection quality per class")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def save_pr_figure(map_report: MAPReport, path: str):
    """Per-class precision-recall curves at IoU=0.50 with AP in the
    legend (the PR_curve.png artifact ultralytics' validator saves)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 5))
    for label in sorted(map_report.pr_curves):
        recall, precision, _ = map_report.pr_curves[label]
        # prepend the (0, p0) start so single-point curves draw a line
        r = np.concatenate(([0.0], recall))
        p = np.concatenate(([precision[0] if len(precision) else 1.0],
                            precision))
        ax.plot(r, p, linewidth=1.5,
                label=f"{label} AP50={map_report.per_class_ap50[label]:.3f}")
    ax.set_xlabel("recall")
    ax.set_ylabel("precision")
    ax.set_xlim(0, 1.0)
    ax.set_ylim(0, 1.05)
    ax.legend(loc="lower left", fontsize=8)
    ax.set_title(f"Precision-Recall (IoU=0.50), mAP50={map_report.map50:.3f}")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def read_yolo_labels(label_path: str, img_w: int, img_h: int,
                     class_names) -> dict:
    """Parse a YOLO-format label txt (class cx cy w h, normalized) into
    {'bboxes': [N,4] xyxy px, 'labels': [names]}
    (reference make_prediction.py:580-626)."""
    boxes, labels = [], []
    try:
        with open(label_path) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 5:
                    continue
                cid = int(float(parts[0]))
                cx, cy, w, h = (float(v) for v in parts[1:5])
                x1 = (cx - w / 2) * img_w
                y1 = (cy - h / 2) * img_h
                x2 = (cx + w / 2) * img_w
                y2 = (cy + h / 2) * img_h
                boxes.append([x1, y1, x2, y2])
                labels.append(class_names[cid])
    except FileNotFoundError:
        pass
    return {"bboxes": np.asarray(boxes, np.float64).reshape(-1, 4),
            "labels": labels}
