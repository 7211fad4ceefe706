"""The plain reference of a tiled survey run: the catalog that
`cli.run --split_img_in_tiles` should write for a field, worked out in
float32 (no TF32) with plain PyTorch and numpy.  Imports nothing of the
program.

Steps, each written from the published algorithm it follows:
  tiles        the reference package's grid (half-open windows, fractional
               step, partial windows at the far edges)
  chain        the preprocessing flags of the run: zscale (IRAF / astropy
               ZScaleInterval), masked min-max, sigma-clipped background
               (astropy sigma_clip: median centre, ddof-0 std, 5 rounds,
               bounds intersected), the three-channel composite with
               histogram equalisation (skimage, 256 bins); pixels that are
               0 or not finite stay out of every statistic and come out 0
  model        letterbox (bilinear, half-pixel centres, 114/255 pad),
               `reference.model`, DFL decode, greedy class-aware NMS
  catalog      per-tile merge of overlapping detections, the objects'
               integer boxes and edge flags, edge flags from neighbouring
               tiles, the stitch of edge sources across tiles
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch
import torch.nn.functional as F

from reference.model import decode

PAD_VALUE = 114.0 / 255.0
MAX_WH = 7680.0
CLASS_NAMES = ("spurious", "compact", "extended", "extended-multisland",
               "flagged")


# -- run flags ---------------------------------------------------------------

def parse_flags(flags: list[str]):
    """The cli.run flags the reference implements; any other flag is
    refused, so a traffic file cannot ask for what it does not check."""
    p = argparse.ArgumentParser()
    for name in ("preprocessing", "zscale_stretch", "normalize_minmax",
                 "subtract_bkg", "chan3_preproc", "split_img_in_tiles"):
        p.add_argument(f"--{name}", action="store_true")
    for name, default in (("norm_min", 0.0), ("norm_max", 1.0),
                          ("sigma_bkg", 3.0), ("sigma_clip_baseline", 0.0),
                          ("sigma_clip_low", 10.0), ("sigma_clip_up", 10.0),
                          ("tile_xstep", 1.0), ("tile_ystep", 1.0),
                          ("scoreThr", 0.7), ("iouThr", 0.5),
                          ("merge_overlap_iou_thr_soft", 0.3),
                          ("merge_overlap_iou_thr_hard", 0.8)):
        p.add_argument(f"--{name}", type=float, default=default)
    for name, default in (("tile_xsize", 512), ("tile_ysize", 512),
                          ("imgsize", 640), ("pre_nms", 512),
                          ("batch_size", 128),
                          ("max_ntasks_per_worker", 100)):
        p.add_argument(f"--{name}", type=int, default=default)
    p.add_argument("--zscale_contrasts", default="0.25,0.25,0.25")
    return p.parse_args(flags)


# -- tiles -------------------------------------------------------------------

def _axis(n: int, size: int, step: int):
    out, i = [], 0
    while i < n and min(size, n - i) > 0:
        out.append((i, i + min(size, n - i)))
        i += step
    return out


def tile_grid(ny: int, nx: int, a) -> list[tuple[int, int, int, int]]:
    """(x0, x1, y0, y1) half-open windows, row by row."""
    xs = _axis(nx, a.tile_xsize, int(np.round(a.tile_xstep * a.tile_xsize)))
    ys = _axis(ny, a.tile_ysize, int(np.round(a.tile_ystep * a.tile_ysize)))
    return [(x0, x1, y0, y1) for y0, y1 in ys for x0, x1 in xs]


# -- preprocessing -----------------------------------------------------------

def valid(x):
    return (x != 0) & torch.isfinite(x)


def zscale_limits(planes, contrast=0.25, nsamples=1000, max_reject=0.5,
                  min_npixels=5, krej=2.5, max_iterations=5):
    """astropy ZScaleInterval on each plane [P, ...] -> (vmin, vmax) f32,
    the fit in float64, every plane's loop stopped where astropy's would
    be (no fewer bad samples than before, or too few good ones)."""
    flat = planes.reshape(planes.shape[0], -1)
    stride = int(max(1.0, flat.shape[1] / nsamples))
    s = torch.sort(flat[:, ::stride][:, :nsamples].double(), 1).values
    p, npix = s.shape
    x = torch.arange(npix, dtype=torch.float64, device=s.device)
    minpix = max(min_npixels, int(npix * max_reject))
    ngrow = max(1, int(npix * 0.01))
    bad = torch.zeros_like(s, dtype=torch.bool)
    ngood = torch.full((p,), npix, device=s.device)
    last = torch.full((p,), npix + 1, device=s.device)
    slope = torch.zeros(p, dtype=torch.float64, device=s.device)
    fitted = torch.zeros(p, dtype=torch.bool, device=s.device)
    active = torch.ones(p, dtype=torch.bool, device=s.device)
    for _ in range(max_iterations):
        active &= (ngood < last) & (ngood >= minpix)
        w = (~bad).double()
        sw, sx, sy = w.sum(1), (w * x).sum(1), (w * s).sum(1)
        sxx, sxy = (w * x * x).sum(1), (w * x * s).sum(1)
        fit = (sw * sxy - sx * sy) / (sw * sxx - sx * sx)
        resid = s - ((sy - fit * sx) / sw)[:, None] - fit[:, None] * x
        mu = (w * resid).sum(1) / sw
        thr = krej * torch.sqrt((w * (resid - mu[:, None]) ** 2).sum(1) / sw)
        new_bad = bad | (resid < -thr[:, None]) | (resid > thr[:, None])
        new_bad = F.max_pool1d(
            F.pad(new_bad.double()[:, None], (ngrow // 2, (ngrow - 1) // 2)),
            ngrow, 1)[:, 0] > 0
        bad = torch.where(active[:, None], new_bad, bad)
        slope = torch.where(active, fit, slope)
        fitted |= active
        last = torch.where(active, ngood, last)
        ngood = torch.where(active, (~bad).sum(1), ngood)
    vmin, vmax = s[:, 0], s[:, -1]
    median = 0.5 * (s[:, (npix - 1) // 2] + s[:, npix // 2])
    center = (npix - 1) // 2
    sl = slope / contrast if contrast > 0 else slope
    use = fitted & (ngood >= minpix)
    lo = torch.where(use, torch.maximum(vmin, median - (center - 1) * sl),
                     vmin)
    hi = torch.where(use, torch.minimum(vmax, median + (npix - center) * sl),
                     vmax)
    # the reference package's guard (its ops/zscale.py): an interval that
    # is empty to 1e-5 of its magnitude falls back to the samples' range,
    # as on a plane that is mostly one value
    empty = ~(hi - lo > torch.maximum(lo.abs(), hi.abs()) * 1e-5
              + (vmax - vmin) * 1e-12)
    lo, hi = torch.where(empty, vmin, lo), torch.where(empty, vmax, hi)
    return lo.float(), hi.float()


def zscale(planes, contrast):
    vmin, vmax = zscale_limits(planes, contrast)
    vmin, vmax = vmin[:, None, None], vmax[:, None, None]
    span = vmax - vmin
    z = torch.where(span != 0, (planes - vmin) / torch.where(
        span != 0, span, 1.0), planes - vmin).clamp(0.0, 1.0)
    return torch.where(valid(planes), z, 0.0)


def minmax(planes, lo_out, hi_out):
    """-> (planes, ok[P])."""
    m = valid(planes)
    lo = torch.where(m, planes, math.inf).amin((1, 2))
    hi = torch.where(m, planes, -math.inf).amax((1, 2))
    span = (hi - lo)[:, None, None]
    out = ((planes - lo[:, None, None]) / torch.where(span != 0, span, 1.0)
           * (hi_out - lo_out) + lo_out)
    return torch.where(m, out, 0.0), torch.isfinite(lo) & (hi > lo)


def clip_stats(planes, sigma_low, sigma_up, iters=5):
    """astropy sigma_clip(cenfunc=median, stdfunc=std, maxiters=5) of the
    valid pixels of each plane -> (mean, lower, upper, n_valid), each [P];
    mean and variance in float64."""
    p = planes.shape[0]
    x = planes.reshape(p, -1)
    m0 = valid(x)
    lo = torch.full((p,), -math.inf, device=x.device)
    up = torch.full((p,), math.inf, device=x.device)

    def stats(lo, up):
        keep = m0 & (x >= lo[:, None]) & (x <= up[:, None])
        n = keep.sum(1)
        srt = torch.sort(torch.where(keep, x, math.inf), 1).values
        ni = n.clamp(min=1)
        med = 0.5 * (srt.gather(1, ((ni - 1) // 2)[:, None])[:, 0]
                     + srt.gather(1, (ni // 2)[:, None])[:, 0])
        v = torch.where(keep, x, 0.0).double()
        mean = v.sum(1) / ni
        var = ((v * v).sum(1) / ni - mean * mean).clamp(min=0.0)
        return med, mean.float(), torch.sqrt(var.float())

    lower, upper = lo, up
    for _ in range(iters):
        med, _, std = stats(lo, up)
        lower, upper = med - sigma_low * std, med + sigma_up * std
        lo, up = torch.maximum(lo, lower), torch.minimum(up, upper)
    _, mean, _ = stats(lo, up)
    return mean, lower, upper, m0.sum(1)


def equalize_hist(planes, nbins=256):
    """skimage equalize_hist of each whole plane over its own range."""
    p = planes.shape[0]
    flat = planes.reshape(p, -1)
    vmin = flat.amin(1, keepdim=True)
    vmax = flat.amax(1, keepdim=True)
    span = torch.where(vmax > vmin, vmax - vmin, 1.0)
    idx = ((flat - vmin) / span * nbins).clamp(0, nbins - 1).long()
    hist = torch.zeros(p, nbins, device=flat.device).scatter_add_(
        1, idx, torch.ones_like(flat))
    cdf = hist.cumsum(1)
    cdf = cdf / cdf[:, -1:]
    step = span / nbins
    pos = ((flat - (vmin + 0.5 * step)) / step).clamp(0.0, nbins - 1.0)
    i0 = pos.long().clamp(max=nbins - 2)
    f = (pos - i0).clamp(0.0, 1.0)
    out = cdf.gather(1, i0) * (1 - f) + cdf.gather(1, i0 + 1) * f
    return out.reshape(planes.shape)


def preprocess(planes, a):
    """Gray tiles [B, H, W] -> (model inputs [B, 3, H, W], ok[B])."""
    ok = torch.ones(planes.shape[0], dtype=torch.bool, device=planes.device)
    x = planes
    if not a.preprocessing:
        chans = [x, x, x]
    else:
        contrast = float(a.zscale_contrasts.split(",")[0])
        if a.subtract_bkg:
            mean, _, _, n = clip_stats(x, a.sigma_bkg, a.sigma_bkg)
            x = torch.where(valid(x), x - mean[:, None, None], 0.0)
            ok &= n > 0
        if a.chan3_preproc:
            chans = []
            for low in (a.sigma_clip_baseline, a.sigma_clip_low):
                _, lower, upper, n = clip_stats(x, low, a.sigma_clip_up)
                c = torch.minimum(torch.maximum(x, lower[:, None, None]),
                                  upper[:, None, None])
                c = torch.where(valid(x), c, 0.0)
                chans.append(zscale(c, contrast))
                ok &= n > 0
            chans.append(torch.where(valid(x), equalize_hist(x), 0.0))
        else:
            if a.zscale_stretch:
                x = zscale(x, contrast)
            chans = [x]
        if a.normalize_minmax:
            out = []
            for c in chans:
                c, good = minmax(c, a.norm_min, a.norm_max)
                out.append(c)
                ok &= good
            chans = out
        if len(chans) == 1:
            chans = chans * 3
    imgs = torch.stack(chans, 1)
    flat = imgs.flatten(2)
    return imgs, ok & (flat.amax(2) > flat.amin(2)).all(1)


# -- detection ---------------------------------------------------------------

def letterbox_geometry(h, w, s):
    r = min(s / h, s / w)
    nh, nw = round(h * r), round(w * r)
    return r, nh, nw, round((s - nh) / 2 - 0.1), round((s - nw) / 2 - 0.1)


def letterbox(imgs, s):
    h, w = imgs.shape[-2:]
    _, nh, nw, top, left = letterbox_geometry(h, w, s)
    if (nh, nw) != (h, w):
        imgs = F.interpolate(imgs, size=(nh, nw), mode="bilinear",
                             align_corners=False, antialias=False)
    return F.pad(imgs, (left, s - nw - left, top, s - nh - top),
                 value=PAD_VALUE)


def iou_np(a, b):
    """Pairwise IoU of xyxy boxes [N, 4] and [M, 4] in their dtype."""
    iw = (np.minimum(a[:, None, 2], b[None, :, 2])
          - np.maximum(a[:, None, 0], b[None, :, 0]))
    ih = (np.minimum(a[:, None, 3], b[None, :, 3])
          - np.maximum(a[:, None, 1], b[None, :, 1]))
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1), 0)


def nms(boxes, conf, cls, a, max_det=300):
    """Greedy class-aware NMS of one image's candidates (host numpy):
    conf > thr, the pre_nms best by score (ties by index), suppressed by a
    kept box of higher score with IoU > iou_thr."""
    idx = np.nonzero(conf > a.scoreThr)[0]
    idx = idx[np.argsort(-conf[idx], kind="stable")][:a.pre_nms]
    b = boxes[idx] + (cls[idx, None] * MAX_WH).astype(np.float32)
    iou = iou_np(b, b)
    keep = []
    for i in range(len(idx)):
        if all(iou[j, i] <= a.iouThr for j in keep):
            keep.append(i)
    keep = idx[keep[:max_det]]
    return boxes[keep], conf[keep], cls[keep]


def detect_tiles(model, mosaic, windows, a, device, batch=32):
    """Windows (x0, x1, y0, y1) of the mosaic [H, W] f32 (NaN as 0) ->
    per window (boxes [N, 4] xyxy in tile pixels, scores [N], cls [N]), or
    None where the tile cannot be predicted on."""
    out = [None] * len(windows)
    by_shape = {}
    for k, (x0, x1, y0, y1) in enumerate(windows):
        by_shape.setdefault((y1 - y0, x1 - x0), []).append(k)
    for (h, w), ks in by_shape.items():
        r, _, _, top, left = letterbox_geometry(h, w, a.imgsize)
        shift = np.array([left, top, left, top], np.float32)
        lim = np.array([w, h, w, h], np.float32)
        for i in range(0, len(ks), batch):
            part = ks[i:i + batch]
            planes = torch.stack([
                torch.from_numpy(mosaic[windows[k][2]:windows[k][3],
                                        windows[k][0]:windows[k][1]])
                for k in part]).to(device)
            imgs, ok = preprocess(planes, a)
            with torch.no_grad():
                boxes, scores, _ = decode(model(letterbox(imgs, a.imgsize)),
                                          a.imgsize)
            conf, cls = scores.max(-1)
            boxes, conf, cls, ok = (t.cpu().numpy() for t in
                                    (boxes, conf, cls, ok))
            for j, k in enumerate(part):
                if not ok[j]:
                    continue
                bb, cc, kk = nms(boxes[j], conf[j], cls[j], a)
                bb = np.minimum(np.clip((bb - shift) / np.float32(r), 0,
                                        None), lim)
                out[k] = (bb, cc, kk)
    return out


# -- catalog -----------------------------------------------------------------

def _components(n, pairs):
    parent = list(range(n))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i, j in pairs:
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[max(ri, rj)] = min(ri, rj)
    comps = {}
    for i in range(n):
        comps.setdefault(find(i), []).append(i)
    return [comps[k] for k in sorted(comps)]


def merge(boxes, scores, cls, soft, hard):
    """Per connected component of mergeable detections (IoU >= hard, or
    same class and IoU >= soft) the best-scoring one (lowest index on
    ties), components in order of their lowest index."""
    if len(boxes) == 0:
        return boxes, scores, cls
    b = boxes.astype(np.float64)
    iou = iou_np(b, b)
    ok = (iou >= hard) | ((cls[:, None] == cls[None, :]) & (iou >= soft))
    np.fill_diagonal(ok, False)
    pairs = np.argwhere(np.triu(ok, 1))
    keep = [c[int(np.argmax(scores[c]))] for c in
            (np.asarray(c) for c in _components(len(b), pairs))]
    return boxes[keep], scores[keep], cls[keep]


def tile_objects(det, window, a):
    x0, x1, y0, y1 = window
    boxes, scores, cls = merge(*det, a.merge_overlap_iou_thr_soft,
                               a.merge_overlap_iou_thr_hard)
    h, w = y1 - y0, x1 - x0
    objs = []
    for b, s, c in zip(boxes.astype(np.float64), scores, cls):
        bx1, by1, bx2, by2 = (int(v) for v in b)
        edge = (bx1 <= 0 or bx1 >= w - 1 or bx2 <= 0 or bx2 >= w - 1
                or by1 <= 0 or by1 >= h - 1 or by2 <= 0 or by2 >= h - 1)
        objs.append({"x1": float(x0 + bx1), "x2": float(x0 + bx2),
                     "y1": float(y0 + by1), "y2": float(y0 + by2),
                     "class_id": int(c), "class_name": CLASS_NAMES[int(c)],
                     "score": float(s), "edge": bool(edge)})
    return objs


def _neighbours(windows):
    w = np.asarray(windows)
    x0, x1, y0, y1 = w[:, 0], w[:, 1], w[:, 2], w[:, 3]
    adj_x = ((x1[:, None] == x0[None]) | (x0[:, None] == x1[None])
             | ((x0[:, None] == x0[None]) & (x1[:, None] == x1[None])))
    adj_y = ((y1[:, None] == y0[None]) | (y0[:, None] == y1[None])
             | ((y0[:, None] == y0[None]) & (y1[:, None] == y1[None])))
    olap = ((x1[:, None] > x0[None]) & (x0[:, None] < x1[None])
            & (y1[:, None] > y0[None]) & (y0[:, None] < y1[None]))
    nb = (adj_x & adj_y) | olap
    np.fill_diagonal(nb, False)
    return nb


def stitch(tile_objs, windows):
    """Edge flags from neighbouring tiles, then the stitch: edge sources
    in neighbouring tiles whose boxes overlap (closed intervals) form
    components; a component of several becomes their enclosing box with
    the class and score of its largest member."""
    nb = _neighbours(windows)
    for t, objs in enumerate(tile_objs):
        x0, x1, y0, y1 = windows[t]
        for o in objs:
            if (o["x1"] == x0 or o["x2"] == x1 or o["y1"] == y0
                    or o["y2"] == y1):
                o["edge"] = True
                continue
            for n in np.nonzero(nb[t])[0]:
                u0, u1, v0, v1 = windows[n]
                if not (o["x2"] < u0 or o["x1"] >= u1 or o["y2"] < v0
                        or o["y1"] >= v1):
                    o["edge"] = True
                    break
    sources, edge = [], []
    for t, objs in enumerate(tile_objs):
        for o in objs:
            if o["edge"]:
                edge.append((t, o))
            else:
                sources.append(dict(o, merged=False))
    pairs = []
    if edge:
        tid = np.asarray([t for t, _ in edge])
        bx = np.asarray([[o["x1"], o["y1"], o["x2"], o["y2"]]
                         for _, o in edge])
        for i in range(len(edge)):
            rest = bx[i + 1:]
            touch = ~((bx[i, 2] < rest[:, 0]) | (bx[i, 0] > rest[:, 2])
                      | (bx[i, 3] < rest[:, 1]) | (bx[i, 1] > rest[:, 3]))
            js = np.nonzero(touch & nb[tid[i], tid[i + 1:]])[0] + i + 1
            pairs += [(i, int(j)) for j in js]
    for comp in _components(len(edge), pairs):
        members = [edge[k][1] for k in comp]
        if len(members) == 1:
            sources.append(dict(members[0], merged=False))
            continue
        big = max(members, key=lambda m: (
            (m["x2"] - m["x1"]) * (m["y2"] - m["y1"]), m["score"],
            m["class_id"], m["x1"], m["y1"]))
        sources.append({
            "x1": min(m["x1"] for m in members),
            "x2": max(m["x2"] for m in members),
            "y1": min(m["y1"] for m in members),
            "y2": max(m["y2"] for m in members),
            "edge": True, "merged": True, "score": big["score"],
            "class_id": big["class_id"], "class_name": big["class_name"]})
    return sources


def catalog(model, mosaic, flags, device):
    """The field's stitched sources, as the run's catalog lists them."""
    a = parse_flags(flags)
    windows = tile_grid(*mosaic.shape, a)
    dets = detect_tiles(model, mosaic, windows, a, device)
    tile_objs = [tile_objects(d, w, a) if d is not None else []
                 for d, w in zip(dets, windows)]
    return stitch(tile_objs, windows)
