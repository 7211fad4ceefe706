"""Histogram equalisation of planes (the plain version of kernel K6).

Counterpart of caesar_yolo_tpu/ops/histeq.py (skimage equalize_hist with
nbins=256, reference preprocessing.py:1004), batched over planes, with
its order of operations: the histogram of each whole plane over its own
[min, max] (a NaN anywhere makes the plane's output NaN, as jnp.min
propagates it), the CDF normalised by its last entry, and linear
interpolation at the bin centres.  Output lands in [0, 1].

Float -> int conversions take NaN to bin 0 explicitly, as XLA's
saturating conversion does; PyTorch leaves NaN -> int undefined.
"""

from __future__ import annotations

import torch

NBINS = 256


def _to_index(v: torch.Tensor, hi: int) -> torch.Tensor:
    """clip(int(v), 0, hi) with int(NaN) = 0 (XLA's conversion)."""
    return torch.nan_to_num(v, nan=0.0).clamp(0.0, float(hi)).long()


def equalize_hist(planes: torch.Tensor, nbins: int = NBINS) -> torch.Tensor:
    """planes [P, H, W] -> equalised f32 [P, H, W] in [0, 1]."""
    p = planes.shape[0]
    flat = planes.reshape(p, -1).float()
    vmin = flat.amin(dim=1, keepdim=True)
    vmax = flat.amax(dim=1, keepdim=True)
    span = torch.where(vmax > vmin, vmax - vmin, 1.0)
    # bin i covers [vmin + i*span/nbins, vmin + (i+1)*span/nbins), the top
    # edge inclusive (numpy histogram convention)
    idx = _to_index((flat - vmin) / span * nbins, nbins - 1)
    offsets = torch.arange(p, device=flat.device)[:, None] * nbins
    hist = torch.bincount((idx + offsets).reshape(-1),
                          minlength=p * nbins).reshape(p, nbins)
    cdf = hist.cumsum(dim=1).float()
    cdf = cdf / cdf[:, -1:]
    # interpolation at the uniform bin centres, clamped to the end values
    # outside [centres[0], centres[-1]] as np.interp does
    step = span / nbins
    c0 = vmin + 0.5 * step
    pos = torch.clamp((flat - c0) / step, 0.0, float(nbins - 1))
    i0 = _to_index(pos, nbins - 2)
    f = torch.clamp(pos - i0.float(), 0.0, 1.0)
    out = (torch.gather(cdf, 1, i0) * (1.0 - f)
           + torch.gather(cdf, 1, i0 + 1) * f)
    return out.reshape(planes.shape)
