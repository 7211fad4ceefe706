"""Sigma-clipped statistics of tile planes (kernel K5).

Counterpart of caesar_yolo_tpu/ops/pallas_stats.py.  For each plane:
the astropy-default sigma-clipped (mean, median, std, lower, upper,
n_valid) over the valid pixels (finite and != 0), with an exact median
(see ops/stats.py for the algorithm).  Used by the background
subtraction and both clips of the chan3 chain.

On a CUDA tensor `clip_stats` launches the hand-written kernel in
csrc/stats.cu (one block per plane; see the source for its design and
bound).  On a CPU tensor it runs `ops.stats.clip_stats_plain`, the same
arithmetic in PyTorch.  The kernel derives the mask from the values, so
an explicit mask is taken on the CPU only.
"""

from __future__ import annotations

import ctypes

import torch

from caesar_yolo_tpu_torch import cuda_build
from caesar_yolo_tpu_torch.ops.stats import clip_stats_plain


def clip_stats(values: torch.Tensor, sigma_low: float, sigma_up: float,
               maxiters: int = 5, mask: torch.Tensor | None = None):
    """values [P, H, W] f32 -> (stats [P, 5] f32 = mean, median, std,
    lower, upper; counts [P, 2] int32 = n_valid, final kept count).
    CUDA tensors launch the kernel; CPU tensors take `clip_stats_plain`
    (where `mask` may replace the values' own valid mask)."""
    if not values.is_cuda:
        return clip_stats_plain(values, mask, sigma_low, sigma_up, maxiters)
    if mask is not None or values.ndim != 3 or values.dtype != torch.float32:
        raise ValueError(
            f"sigma-clip kernel does not take values {tuple(values.shape)} "
            f"{values.dtype}{' with an explicit mask' if mask is not None else ''}"
            f" (it reads f32 planes [P, H, W] and derives their mask)")
    p = values.shape[0]
    hw = values[0].numel()
    values = values.contiguous()
    stats = torch.empty((p, 5), dtype=torch.float32, device=values.device)
    counts = torch.empty((p, 2), dtype=torch.int32, device=values.device)
    fn = cuda_build.load("stats").cy_sigma_clip_stats
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    clip_stats.launches += 1
    cuda_build.check(fn(values.data_ptr(), stats.data_ptr(),
                        counts.data_ptr(), p, hw, float(sigma_low),
                        float(sigma_up), int(maxiters),
                        cuda_build.stream_ptr(values.device)),
                     "sigma-clip kernel")
    return stats, counts


clip_stats.launches = 0


# The kernel against its plain version: n_valid equal; where the final
# kept counts agree, the median exactly (the same bisection and pin) and
# mean, std, lower and upper within STATS_RTOL of the largest magnitude
# among the plane's five statistics (f32 sums in another order; a bound
# near zero is the difference of two larger numbers).  A kept count may
# differ by at most KEPT_SLACK pixels, when a pixel lies at rounding
# distance from a bound; such a plane's statistics move by about one
# pixel's weight, so they are held within KEPT_RTOL instead.
STATS_RTOL = 1e-5
KEPT_SLACK = 2
KEPT_RTOL = 1e-3


def stats_mismatch(got, ref) -> str | None:
    """got, ref: (stats [P, 5], counts [P, 2]) of the kernel and of
    `clip_stats_plain` on the same planes -> None when they agree by the
    rule above, else what differs."""
    gs, gc = (t.detach().cpu() for t in got)
    rs, rc = (t.detach().cpu() for t in ref)
    if not torch.equal(gc[:, 0], rc[:, 0]):
        return "n_valid differs"
    if not torch.equal(gs.isnan(), rs.isnan()):
        return "NaN statistics differ"
    dkept = (gc[:, 1] - rc[:, 1]).abs()
    if bool((dkept > KEPT_SLACK).any()):
        return f"kept counts differ by {int(dkept.max())}"
    same = dkept == 0
    if not torch.equal(gs[same, 1].nan_to_num(), rs[same, 1].nan_to_num()):
        return "median differs where the kept sets agree"
    scale = rs.nan_to_num().abs().amax(dim=1, keepdim=True)
    err = (gs - rs).nan_to_num().abs()
    tol = torch.where(same[:, None], STATS_RTOL, KEPT_RTOL) * scale
    if bool((err > tol).any()):
        bad = (err / scale.clamp(min=1e-30)).max().item()
        return f"statistics differ by {bad:.3g} of the plane's scale"
    return None
