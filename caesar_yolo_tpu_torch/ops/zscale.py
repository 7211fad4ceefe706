"""ZScale display interval (IRAF zscale, astropy ZScaleInterval defaults),
batched over tiles in plain PyTorch.

Counterpart of caesar_yolo_tpu/ops/zscale.py, with the same algorithm
step for step: subsample with stride int(max(1, n / nsamples)), sort,
fit a line to the median-centred samples with k-sigma rejection and a
ones(ngrow) mask dilation (numpy 'same' convolution offsets), freeze once
fewer than minpix samples are good, then derive the limits, with the
reference's degenerate-fit guard.  The reference computes these limits
outside its kernel too (pallas_preproc.py:89-91).

The fit's f32 sums run in another order than XLA's, so the limits agree
with the reference to f32 rounding (relative ~1e-6), not bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _dilate(bad: torch.Tensor, ngrow: int) -> torch.Tensor:
    """np.convolve(bad, ones(ngrow), mode='same') > 0, per row: the
    window of output i is [i - ngrow//2, i + (ngrow-1)//2]."""
    x = F.pad(bad.float()[:, None, :], (ngrow // 2, (ngrow - 1) // 2))
    return F.max_pool1d(x, ngrow, stride=1)[:, 0, :] > 0


def zscale_limits(values: torch.Tensor, contrast: float = 0.25,
                  nsamples: int = 1000, max_reject: float = 0.5,
                  min_npixels: int = 5, krej: float = 2.5,
                  max_iterations: int = 5):
    """values [B, ...] -> (vmin[B], vmax[B]) f32, one interval per tile."""
    flat = values.reshape(values.shape[0], -1).float()
    n = flat.shape[1]
    stride = int(max(1.0, n / nsamples))
    v = torch.sort(flat[:, ::stride][:, :nsamples], dim=1).values
    npix = v.shape[1]
    vmin0, vmax0 = v[:, 0], v[:, -1]

    minpix = max(min_npixels, int(npix * max_reject))
    ngrow = max(1, int(npix * 0.01))
    x = torch.arange(npix, dtype=torch.float32, device=v.device)
    center = (npix - 1) // 2
    median = 0.5 * (v[:, (npix - 1) // 2] + v[:, npix // 2])
    # median-centred fit, as the reference (keeps the x*v sums at the
    # scale of the sample spread)
    v = v - median[:, None]

    bad = torch.zeros_like(v, dtype=torch.bool)
    ngood = torch.full_like(vmin0, npix, dtype=torch.int64)
    slope = torch.zeros_like(vmin0)
    for _ in range(max_iterations):
        w = (~bad).float()
        sw = w.sum(1)
        sx = (w * x).sum(1)
        sy = (w * v).sum(1)
        sxx = (w * x * x).sum(1)
        sxy = (w * x * v).sum(1)
        denom = sw * sxx - sx * sx
        fit = torch.where(denom != 0, (sw * sxy - sx * sy) / denom, 0.0)
        sw1 = sw.clamp(min=1.0)
        intercept = (sy - fit * sx) / sw1
        resid = v - (intercept[:, None] + fit[:, None] * x)
        mu = (w * resid).sum(1) / sw1
        var = ((w * resid * resid).sum(1) / sw1 - mu * mu).clamp(min=0.0)
        threshold = (krej * torch.sqrt(var))[:, None]
        new_bad = bad | (resid < -threshold) | (resid > threshold)
        new_bad = _dilate(new_bad, ngrow)
        # freeze once below minpix (astropy stops there)
        keep_going = ngood >= minpix
        bad = torch.where(keep_going[:, None], new_bad, bad)
        slope = torch.where(keep_going, fit, slope)
        ngood = (~bad).sum(1)

    fitted_ok = ngood >= minpix
    if contrast > 0:
        slope = slope / contrast
    vmin = torch.maximum(vmin0, median - (center - 1) * slope)
    vmax = torch.minimum(vmax0, median + (npix - center) * slope)
    vmin = torch.where(fitted_ok, vmin, vmin0)
    vmax = torch.where(fitted_ok, vmax, vmax0)
    # degenerate-fit guard of the reference (zscale.py:105-124)
    scale = torch.maximum(vmin.abs(), vmax.abs())
    bad_interval = ~(vmax - vmin > scale * 1e-5 + (vmax0 - vmin0) * 1e-12)
    vmin = torch.where(bad_interval, vmin0, vmin)
    vmax = torch.where(bad_interval, vmax0, vmax)
    return vmin, vmax


def zscale_apply(x: torch.Tensor, vmin: torch.Tensor,
                 vmax: torch.Tensor) -> torch.Tensor:
    """Map x through (vmin, vmax) to [0, 1], clipped; vmin/vmax broadcast
    against x.  NaN propagates through the clip, as jnp.clip does."""
    span = vmax - vmin
    nz = span != 0
    out = torch.where(nz, (x - vmin) / torch.where(nz, span, 1.0), x - vmin)
    return torch.clamp(out, 0.0, 1.0)
