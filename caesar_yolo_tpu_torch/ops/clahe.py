"""Contrast-limited adaptive histogram equalisation (CLAHE) of planes (the
plain version of kernel K7).

Counterpart of caesar_yolo_tpu/ops/clahe.py (skimage equalize_adapthist
parameterised as the reference's HistEqualizer(adaptive=True) reaches it:
an 8x8 grid of contextual tiles, 256 bins, clip limit relative to the
padded tile's pixel count), in its XLA gather form, batched over planes:

  - bins from the plane's global range: int((x - vmin) / span * 256)
    clipped to [0, 255], span 1 on a constant plane; a NaN anywhere makes
    vmin NaN and every bin 0, as jnp.min propagates it and XLA converts
    NaN to 0;
  - the plane reflect-padded (jnp.pad mode "reflect") to a multiple of the
    grid, and one 256-bin histogram per contextual tile;
  - 8 sweeps of clip + uniform redistribution of the excess, the CDF
    normalised by its last entry;
  - every pixel maps through a bilinear blend of the 4 surrounding tiles'
    CDFs at its bin, with clamped tile coordinates, written as lerps
    (a + f * (b - a)): equal CDF values blend to themselves exactly, so a
    uniform plane stays uniform, the fixpoint the reference's XLA form
    keeps (tests/test_pallas_clahe.py:test_clahe_uniform_image_fixpoint)
    and the weighted-sum form ((v00*(1-fx) + v01*fx)*(1-fy) + ...) loses
    in unfused f32 arithmetic.

Kernel K7 (ops/cuda_clahe.py, csrc/clahe.cu) builds the tables on chip,
so the two sums over a tile's 256 bins have one stated order here, which
the kernel follows (one warp a tile, lane l holding bins 8l .. 8l + 7):

  - the clipped excess of a sweep is a pairwise tree: eight levels of
    a[..., 0::2] + a[..., 1::2] (`tree_sum`);
  - the cumulative sum is taken within each lane's eight bins in order,
    the lanes' totals are scanned by five Hillis-Steele steps (t[l] +=
    t[l - o] for o = 1, 2, 4, 8, 16), and each lane adds the total of
    the lanes before it (`lane_scan`).

Each add is one rounded f32 add, so PyTorch on the CPU, PyTorch on the
card and the kernel give the same bits.
"""

from __future__ import annotations

import torch

from caesar_yolo_tpu_torch.ops.histeq import _to_index

NBINS = 256
GRID = 8
SWEEPS = 8


def tile_size(h: int, w: int, grid: int = GRID) -> tuple[int, int]:
    """(th, tw): the contextual tile of the padded plane (ceil division)."""
    th, tw = -(-h // grid), -(-w // grid)
    if th * grid - h > h - 1 or tw * grid - w > w - 1:
        raise ValueError(f"plane {h}x{w} is too small for a reflect pad to "
                         f"a {grid}x{grid} grid")
    return th, tw


def value_range(planes: torch.Tensor):
    """(vmin[P], span[P]) of planes [P, H, W]: span = vmax - vmin, or 1 on a
    constant plane (NaN propagates into vmin, as jnp.min does)."""
    vmin = planes.amin(dim=(1, 2))
    vmax = planes.amax(dim=(1, 2))
    return vmin, torch.where(vmax > vmin, vmax - vmin, 1.0)


def bin_index(planes, vmin, span) -> torch.Tensor:
    """clip(int((x - vmin) / span * 256), 0, 255), NaN -> 0."""
    norm = (planes - vmin[:, None, None]) / span[:, None, None]
    return _to_index(norm * NBINS, NBINS - 1)


def _reflect(n: int, padded: int, device) -> torch.Tensor:
    """Source index of each of `padded` positions of an axis of n
    reflect-padded at its end (jnp.pad mode "reflect")."""
    i = torch.arange(padded, device=device)
    return torch.where(i < n, i, 2 * (n - 1) - i)


def tile_histograms_plain(planes, vmin, span, grid: int = GRID):
    """planes [P, H, W] -> f32 counts [P, grid*grid, 256] of each contextual
    tile of the reflect-padded plane (tiles in row-major order)."""
    p, h, w = planes.shape
    th, tw = tile_size(h, w, grid)
    bins = bin_index(planes, vmin, span)
    bins = bins[:, _reflect(h, th * grid, bins.device)]
    bins = bins[:, :, _reflect(w, tw * grid, bins.device)]
    tiles = bins.reshape(p, grid, th, grid, tw).permute(0, 1, 3, 2, 4)
    tile_id = torch.arange(p * grid * grid, device=bins.device)
    flat = tile_id.reshape(p, grid, grid, 1, 1) * NBINS + tiles
    return torch.bincount(flat.reshape(-1), minlength=p * grid * grid * NBINS
                          ).reshape(p, grid * grid, NBINS).float()


LANES = 32                # a warp: lane l holds bins 8l .. 8l + 7
LANE_BINS = NBINS // LANES


def clip_limit_count(npix: int, clip_limit: float) -> float:
    """The clip limit in counts, max(clip_limit * npix, 1), as a Python
    float (rounded to f32 where it meets the f32 histograms)."""
    return max(clip_limit * npix, 1.0)


def tree_sum(a: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of 256 as a pairwise tree, keepdim."""
    while a.shape[-1] > 1:
        a = a[..., 0::2] + a[..., 1::2]
    return a


def lane_scan(hist: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum over the last axis of 256, in the kernel's
    order: in order within each lane's 8 bins, a Hillis-Steele scan of the
    32 lanes' totals, then each lane's bins plus the total before it."""
    c = hist.reshape(*hist.shape[:-1], LANES, LANE_BINS)
    cols = [c[..., 0]]
    for j in range(1, LANE_BINS):
        cols.append(cols[-1] + c[..., j])
    c = torch.stack(cols, dim=-1)
    t = c[..., -1]
    o = 1
    while o < LANES:
        t = torch.cat([t[..., :o], t[..., o:] + t[..., :-o]], dim=-1)
        o *= 2
    before = torch.cat([torch.zeros_like(t[..., :1]), t[..., :-1]], dim=-1)
    return (c + before[..., None]).reshape(hist.shape)


def clip_redistribute(hist: torch.Tensor, npix: int, clip_limit: float):
    """Clip each histogram [..., 256] at max(clip_limit * npix, 1) and spread
    the clipped mass uniformly, 8 sweeps (the published iterative
    redistribution; caesar_yolo_tpu/ops/clahe.py:clip_redistribute), the
    excess summed by `tree_sum`."""
    limit = clip_limit_count(npix, clip_limit)
    for _ in range(SWEEPS):
        excess = tree_sum((hist - limit).clamp(min=0.0))
        hist = hist.clamp(max=limit) + excess / NBINS
    return hist


def cdf_tables(hist: torch.Tensor, npix: int, clip_limit: float):
    """Clipped, redistributed histograms -> CDFs normalised to end at 1
    (the cumulative sum by `lane_scan`)."""
    cdf = lane_scan(clip_redistribute(hist, npix, clip_limit))
    return cdf / cdf[..., -1:]


def _blend_coords(n: int, tsize: int, grid: int, device):
    """Per row (or column): the two neighbouring tiles and the weight of
    the second, on clamped tile coordinates.  Computed on the CPU, whose
    division by a scalar rounds as the kernel's does (PyTorch's CUDA
    division by a host scalar multiplies by its reciprocal)."""
    t = (torch.arange(n, dtype=torch.float32) + 0.5) / tsize - 0.5
    t0 = t.floor().clamp(0, grid - 1)
    f = (t - t0).clamp(0.0, 1.0)
    t0 = t0.long()
    return (t0.to(device), (t0 + 1).clamp(max=grid - 1).to(device),
            f.to(device))


def blend_plain(planes, vmin, span, cdf, grid: int = GRID):
    """Map each pixel through the bilinear blend of its 4 neighbouring
    tiles' CDFs [P, grid*grid, 256] at its bin -> f32 [P, H, W] in [0, 1]."""
    p, h, w = planes.shape
    th, tw = tile_size(h, w, grid)
    bins = bin_index(planes, vmin, span)
    y0, y1, fy = _blend_coords(h, th, grid, planes.device)
    x0, x1, fx = _blend_coords(w, tw, grid, planes.device)
    table = cdf.reshape(p, grid * grid * NBINS)

    def look(ty, tx):
        idx = ((ty[:, None] * grid + tx[None, :]) * NBINS)[None] + bins
        return torch.gather(table, 1, idx.reshape(p, -1)).reshape(p, h, w)

    fx = fx[None, None, :]
    v00 = look(y0, x0)
    top = v00 + fx * (look(y0, x1) - v00)
    v10 = look(y1, x0)
    bot = v10 + fx * (look(y1, x1) - v10)
    return top + fy[None, :, None] * (bot - top)


def equalize_adapthist_plain(planes: torch.Tensor, clip_limit: float = 0.03,
                             grid: int = GRID) -> torch.Tensor:
    """planes [P, H, W] -> CLAHE f32 [P, H, W] in [0, 1], all in PyTorch."""
    planes = planes.float()
    th, tw = tile_size(*planes.shape[1:], grid)
    vmin, span = value_range(planes)
    hist = tile_histograms_plain(planes, vmin, span, grid)
    return blend_plain(planes, vmin, span,
                       cdf_tables(hist, th * tw, clip_limit), grid)
