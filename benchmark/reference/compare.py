"""Comparisons that decide `correct`.

Catalogs (`catalog_miss`): every source of one catalog that clears the
score threshold by `margin` in logit needs a partner in the other: the
same class and IoU >= 0.5.  The number compared is the larger of the two
directions' shares of clear sources without one.  Rounding in the forward
moves every score a little and lets a few near-equal candidates trade
places in NMS, the merge or the stitch (a stitched source takes the box
of all its members and the class of its largest); a forward computed in
a lower precision, a tile left out or a box moved shows in a large share
of the sources.
"""

from __future__ import annotations

import numpy as np


def logit(p):
    p = np.clip(np.asarray(p, np.float64), 1e-12, 1 - 1e-12)
    return np.log(p / (1 - p))


def _arrays(sources):
    if not sources:
        return (np.zeros((0, 4)), np.zeros(0, np.int64), np.zeros(0))
    boxes = np.asarray([[s["x1"], s["y1"], s["x2"], s["y2"]]
                        for s in sources], np.float64)
    return (boxes, np.asarray([s["class_id"] for s in sources]),
            logit([s["score"] for s in sources]))


def _iou(a, b):
    """IoU of catalog boxes, whose corners are whole pixels: a box spans
    x2 - x1 + 1 pixels, so a one-pixel source has an area."""
    iw = np.minimum(a[:, None, 2], b[None, :, 2]) - np.maximum(
        a[:, None, 0], b[None, :, 0]) + 1
    ih = np.minimum(a[:, None, 3], b[None, :, 3]) - np.maximum(
        a[:, None, 1], b[None, :, 1]) + 1
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    aa = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    ab = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    return inter / (aa[:, None] + ab[None, :] - inter)


def has_partner(a, b, iou_min=0.5, block=512):
    """For each source of a (boxes, cls): whether b has a source of the
    same class with IoU >= iou_min."""
    ab, ac = a[:2]
    bb, bc = b[:2]
    found = np.zeros(len(ab), bool)
    for c in np.unique(ac):
        ia = np.nonzero(ac == c)[0]
        ib = np.nonzero(bc == c)[0]
        if not len(ib):
            continue
        ib = ib[np.argsort(bb[ib, 0])]
        x1 = bb[ib, 0]
        wmax = float((bb[ib, 2] - bb[ib, 0]).max())
        ia = ia[np.argsort(ab[ia, 0])]
        for lo in range(0, len(ia), block):
            rows = ia[lo:lo + block]
            j0 = np.searchsorted(x1, ab[rows, 0].min() - wmax - 1, "left")
            j1 = np.searchsorted(x1, ab[rows, 2].max() + 1, "right")
            if j1 > j0:
                found[rows] = (_iou(ab[rows], bb[ib[j0:j1]])
                               >= iou_min).any(1)
    return found


def catalog_miss(ours, ref, score_thr, margin=0.2):
    """-> (miss, details): the larger direction's share of clear sources
    without a partner (0 when neither catalog has a clear source)."""
    a, b = _arrays(ours), _arrays(ref)
    cut = float(logit(score_thr)) + margin
    out, details = 0.0, {"n_ours": len(a[0]), "n_ref": len(b[0])}
    for name, x, y in (("ours", a, b), ("ref", b, a)):
        clear = x[2] >= cut
        found = has_partner(tuple(t[clear] for t in x), y)
        details[f"clear_{name}"] = int(clear.sum())
        details[f"unmatched_{name}"] = int((~found).sum())
        if len(found):
            out = max(out, float((~found).mean()))
    return out, details


def moving_leaves(grads: dict, floor: float = 1e-3) -> set:
    """Leaves whose reference gradient is not nought to rounding: a norm
    of at least `floor` times the median leaf's (a key's bias under
    softmax moves under Adam or momentum by round-off alone)."""
    norms = {k: float(v.double().norm()) for k, v in grads.items()}
    med = float(np.median(list(norms.values())))
    return {k for k, n in norms.items() if n >= floor * med}


def leaf_gap(ours: dict, ref: dict, keep) -> tuple[float, str]:
    """The worst leaf's gap between the two sides' norms (not the norm of
    their difference), over the reference's norm of that leaf or of the
    median leaf, whichever is larger -> (gap, leaf)."""
    norms = {k: float(ref[k].double().norm()) for k in keep}
    med = float(np.median(list(norms.values())))
    worst, leaf = 0.0, ""
    for k in sorted(keep):
        gap = abs(float(ours[k].double().norm()) - norms[k]) / max(
            norms[k], med)
        if gap > worst:
            worst, leaf = gap, k
    return worst, leaf


def median_gap(ours: dict, ref: dict, keep) -> float:
    """The median over leaves of the gap of norms over max(the leaf's
    reference norm, the median leaf's)."""
    norms = {k: float(ref[k].double().norm()) for k in keep}
    med = float(np.median(list(norms.values())))
    return float(np.median([abs(float(ours[k].double().norm()) - norms[k])
                            / max(norms[k], med) for k in keep]))
