"""Masked sigma-clipped statistics, batched over planes (the plain version
of kernel K5).

Counterpart of caesar_yolo_tpu/ops/stats.py and of the Pallas kernel
caesar_yolo_tpu/ops/pallas_stats.py:sigma_clipped_stats_batch, whose
algorithm this follows step for step, so that the CUDA kernel
(ops/cuda_stats.py, csrc/stats.cu) can be held to it exactly:

  - astropy defaults: cenfunc median, stdfunc std (ddof 0), 5 clip
    iterations, bounds inclusive;
  - the kept set is the INTERSECTION of every iteration's
    [median - sigma_low * std, median + sigma_up * std]; the returned
    bounds are the last iteration's raw ones;
  - the median is the mean of the k1-th and k2-th order statistics, each
    found by a 24-round binary bisection of the value range
    [lo0, vmax] (k2's bracket shares k1's until they split) and pinned
    to an exact member of the set;
  - mean and std from f64 sums over the kept set (squares exact), the
    mean and the variance taken in f64 and each rounded once to f32: the
    CUDA kernel sums in another order, and in f64 that moves the sums far
    less than an f32 ulp, so both get the same bounds and kept sets;
  - an empty mask gives NaN statistics and n_valid = 0.

`clip_stats_plain` returns every statistic plus the final kept count,
which the card's parity check uses; `sigma_clipped_stats` and
`sigma_clip_bounds` are the reference's functions on a batch of planes.
"""

from __future__ import annotations

import torch

BISECT_ROUNDS = 24


def valid_mask(x: torch.Tensor) -> torch.Tensor:
    """The masking convention: a pixel takes part iff it is != 0 and
    finite (caesar_yolo_tpu/ops/transforms.py:valid_mask)."""
    return (x != 0) & torch.isfinite(x)


def _count_le(xm: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """#values of xm [P, N] <= thr [P] (masked-out values are +inf, so an
    infinite threshold counts them too, as the reference does)."""
    return (xm <= thr[:, None]).sum(dim=1)


def _pin(xm, lo, hi, k):
    """The exact k-th order statistic inside the bracket (lo, hi]
    (pallas_stats.py:79-85): the smallest member whose cumulative count
    reaches k, else the next distinct member, else hi."""
    inf = float("inf")
    in_b = (xm > lo[:, None]) & (xm <= hi[:, None])
    m1 = torch.where(in_b, xm, inf).amin(dim=1)
    c1 = _count_le(xm, m1)
    m2 = torch.where(in_b & (xm > m1[:, None]), xm, inf).amin(dim=1)
    return torch.where(c1 >= k, m1, torch.where(torch.isfinite(m2), m2, hi))


def _order_stat_pair(xm, k1, k2, lo0, hi0):
    """(k1-th, k2-th) order statistics (1-based, k2 in {k1, k1 + 1}) of
    the finite values of xm [P, N] by shared binary bisection."""
    lo1, hi1, lo2, hi2 = lo0, hi0, lo0, hi0
    for _ in range(BISECT_ROUNDS):
        mid1 = 0.5 * (lo1 + hi1)
        mid2 = 0.5 * (lo2 + hi2)
        ge1 = _count_le(xm, mid1) >= k1
        ge2 = _count_le(xm, mid2) >= k2
        lo1, hi1 = torch.where(ge1, lo1, mid1), torch.where(ge1, mid1, hi1)
        lo2, hi2 = torch.where(ge2, lo2, mid2), torch.where(ge2, mid2, hi2)
    return _pin(xm, lo1, hi1, k1), _pin(xm, lo2, hi2, k2)


def _stats_of(x, m0, lower, upper, lo0, vmax):
    """(n, median, mean, std) of the values of x [P, N] that are in m0 and
    in [lower, upper] (per plane)."""
    keep = m0 & (x >= lower[:, None]) & (x <= upper[:, None])
    xm = torch.where(keep, x, float("inf"))
    n = keep.sum(dim=1)
    ni = n.clamp(min=1)
    k1 = (ni + 1) // 2
    k2 = ni // 2 + 1
    m1, m2 = _order_stat_pair(xm, k1, k2, lo0, vmax)
    med = 0.5 * (m1 + torch.where(k2 == k1, m1, m2))
    v = torch.where(keep, x, 0.0).double()
    nf = ni.double()
    mean = v.sum(dim=1) / nf
    var = torch.clamp((v * v).sum(dim=1) / nf - mean * mean, min=0.0)
    return n, med, mean.to(x.dtype), torch.sqrt(var.to(x.dtype))


def clip_stats_plain(values: torch.Tensor, mask: torch.Tensor | None,
                     sigma_low: float, sigma_up: float, maxiters: int = 5):
    """values [P, H, W] (mask: same shape bool, default `valid_mask` of
    the values) -> (stats [P, 5] f32 = mean, median, std, lower, upper;
    counts [P, 2] int32 = n_valid, final kept count)."""
    p = values.shape[0]
    x = values.reshape(p, -1).float()
    m0 = valid_mask(x) if mask is None else mask.reshape(p, -1).bool()
    n_valid = m0.sum(dim=1)
    inf = float("inf")
    vmin = torch.where(m0, x, inf).amin(dim=1)
    vmax = torch.where(m0, x, -inf).amax(dim=1)
    span = torch.clamp(vmax - vmin, min=0.0)
    # strictly below vmin even for large-magnitude values (f32 rounding)
    lo0 = vmin - torch.maximum(span, vmin.abs()) * 1e-5 - 1e-30

    lo_acc = torch.full_like(vmin, -inf)
    up_acc = torch.full_like(vmin, inf)
    lower, upper = lo_acc, up_acc
    for _ in range(maxiters):
        _, med, _, std = _stats_of(x, m0, lo_acc, up_acc, lo0, vmax)
        lower = med - sigma_low * std
        upper = med + sigma_up * std
        lo_acc = torch.maximum(lo_acc, lower)
        up_acc = torch.minimum(up_acc, upper)
    n, med, mean, std = _stats_of(x, m0, lo_acc, up_acc, lo0, vmax)

    empty = (n_valid == 0)[:, None]
    stats = torch.where(empty, float("nan"),
                        torch.stack([mean, med, std, lower, upper], dim=1))
    counts = torch.stack([n_valid, n], dim=1).int()
    return stats, counts


def sigma_clipped_stats(values, mask, sigma_low, sigma_up,
                        maxiters: int = 5):
    """The reference's six-tuple (mean, median, std, lower, upper,
    n_valid), each [P], of planes [P, H, W], in plain PyTorch."""
    stats, counts = clip_stats_plain(values, mask, sigma_low, sigma_up,
                                     maxiters)
    return (*stats.unbind(dim=1), counts[:, 0])


def sigma_clip_bounds(values, mask, sigma_low, sigma_up, maxiters: int = 5):
    """Final (lower, upper) clip bounds, each [P], as astropy
    sigma_clip(return_bounds)."""
    stats, _ = clip_stats_plain(values, mask, sigma_low, sigma_up, maxiters)
    return stats[:, 3], stats[:, 4]


def masked_min(values, mask, dim=None):
    """Min over mask==True elements (inf where the mask is empty)."""
    x = torch.where(mask, values, float("inf"))
    return x.amin() if dim is None else x.amin(dim=dim)


def masked_max(values, mask, dim=None):
    """Max over mask==True elements (-inf where the mask is empty)."""
    x = torch.where(mask, values, -float("inf"))
    return x.amax() if dim is None else x.amax(dim=dim)
