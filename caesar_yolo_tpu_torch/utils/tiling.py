"""Tile-grid generation and neighbor math for mosaic splitting.

A copy of caesar_yolo_tpu/utils/tiling.py: the port may not import the JAX
package, not even its host-only modules.

Reproduces the reference grid semantics (utils.py:622-697): the image
range [img_xmin, img_xmax] is INCLUSIVE; tile windows are half-open
[xmin, xmax) (their max pixel excluded, matching the windowed FITS read),
with fractional step sizes in (0, 1] (1 = no overlap).  Also provides the
tile adjacency/overlap predicates used for neighbor discovery
(reference inference.py:123-163).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from caesar_yolo_tpu_torch import logger


def generate_tiles(img_xmin: int, img_xmax: int, img_ymin: int, img_ymax: int,
                   tile_xsize: int, tile_ysize: int,
                   grid_xstep: float, grid_ystep: float):
    """Generate tile windows (xmin, xmax, ymin, ymax) over the image.

    Returns None on invalid inputs (same failure modes as the reference).
    """
    if img_xmax <= img_xmin:
        logger.error("xmax must be > xmin!")
        return None
    if img_ymax <= img_ymin:
        logger.error("ymax must be > ymin!")
        return None
    if tile_xsize <= 0 or tile_ysize <= 0:
        logger.error("Invalid box size given!")
        return None
    if grid_xstep <= 0 or grid_ystep <= 0 or grid_xstep > 1 or grid_ystep > 1:
        logger.error("Invalid grid step size given (null or negative)!")
        return None

    nx = img_xmax - img_xmin + 1
    ny = img_ymax - img_ymin + 1
    if tile_xsize > nx or tile_ysize > ny:
        logger.warning("Invalid box size given (too small or larger than image size)!")
        return None

    step_x = int(np.round(grid_xstep * tile_xsize))
    step_y = int(np.round(grid_ystep * tile_ysize))

    def axis_windows(n, size, step):
        mins, maxs = [], []
        index = 0
        while index <= n:
            offset = min(size, n - index)
            if index >= n or offset == 0:
                break
            mins.append(index)
            maxs.append(index + offset)
            index += step
        return mins, maxs

    iy_min, iy_max = axis_windows(ny, tile_ysize, step_y)
    ix_min, ix_max = axis_windows(nx, tile_xsize, step_x)

    return [
        (img_xmin + x0, img_xmin + x1, img_ymin + y0, img_ymin + y1)
        for y0, y1 in zip(iy_min, iy_max)
        for x0, x1 in zip(ix_min, ix_max)
    ]


@dataclass(frozen=True)
class TileWindow:
    """One tile window; coordinates follow generate_tiles conventions."""

    xmin: int
    xmax: int
    ymin: int
    ymax: int
    tid: int = 0

    @property
    def width(self) -> int:
        return self.xmax - self.xmin

    @property
    def height(self) -> int:
        return self.ymax - self.ymin

    def is_adjacent(self, other: "TileWindow") -> bool:
        """Tile adjacency = touching without sharing pixels (reference
        inference.py:123-135, whose INCLUSIVE coords read
        `xmax == other.xmin - 1`; these windows are half-open, so
        touching is `xmax == other.xmin`)."""
        adj_x = (self.xmax == other.xmin or self.xmin == other.xmax
                 or (self.xmin == other.xmin and self.xmax == other.xmax))
        adj_y = (self.ymax == other.ymin or self.ymin == other.ymax
                 or (self.ymin == other.ymin and self.ymax == other.ymax))
        return adj_x and adj_y

    def is_overlapping(self, other: "TileWindow") -> bool:
        """Tile overlap = at least one shared pixel (reference
        inference.py:137-154 on inclusive coords; half-open here, so
        disjoint is `xmax <= other.xmin`, not `<`)."""
        if self.xmax <= other.xmin:
            return False
        if self.xmin >= other.xmax:
            return False
        if self.ymax <= other.ymin:
            return False
        if self.ymin >= other.ymax:
            return False
        return True

    def is_neighbor(self, other: "TileWindow") -> bool:
        """Neighbor = adjacent or overlapping (reference inference.py:157-163)."""
        return self.is_adjacent(other) or self.is_overlapping(other)


def make_tile_windows(tile_grid) -> list[TileWindow]:
    return [TileWindow(x0, x1, y0, y1, tid=i)
            for i, (x0, x1, y0, y1) in enumerate(tile_grid)]


def neighbor_table(tiles: list[TileWindow]) -> list[list[int]]:
    """For each tile, the tids of its neighbor tiles (index order).

    Replaces the reference's O(T^2) nested python worker/task discovery
    (inference.py:1031-1071) with blocked numpy evaluation of the same
    adjacency/overlap predicates (TileWindow.is_neighbor) — a 10k-tile
    grid resolves in milliseconds instead of minutes.
    """
    n = len(tiles)
    out: list[list[int]] = [[] for _ in range(n)]
    if n < 2:
        return out
    x0 = np.asarray([t.xmin for t in tiles], np.int32)
    x1 = np.asarray([t.xmax for t in tiles], np.int32)
    y0 = np.asarray([t.ymin for t in tiles], np.int32)
    y1 = np.asarray([t.ymax for t in tiles], np.int32)

    blk = 2048  # bounds the [blk, n] temporaries (~2*blk*n bytes peak)
    for lo in range(0, n, blk):
        hi = min(lo + blk, n)
        # cheap candidate prefilter: closed interval touch-or-overlap on
        # both axes is a SUPERSET of is_neighbor (adjacency touches,
        # overlap overlaps, equal intervals are equal); in-place &= keeps
        # at most two block masks alive
        cand = x0[lo:hi, None] <= x1[None, :]
        cand &= x0[None, :] <= x1[lo:hi, None]
        cand &= y0[lo:hi, None] <= y1[None, :]
        cand &= y0[None, :] <= y1[lo:hi, None]
        cand[np.arange(lo, hi) - lo, np.arange(lo, hi)] = False  # self
        ij = np.argwhere(cand)
        if not ij.size:
            continue
        i, j = ij[:, 0] + lo, ij[:, 1]
        # exact predicate on candidates only:
        # is_neighbor = (adj_x & adj_y) | (olap_x & olap_y)
        ax = ((x1[i] == x0[j]) | (x0[i] == x1[j])
              | ((x0[i] == x0[j]) & (x1[i] == x1[j])))
        ay = ((y1[i] == y0[j]) | (y0[i] == y1[j])
              | ((y0[i] == y0[j]) & (y1[i] == y1[j])))
        ox = (x1[i] > x0[j]) & (x0[i] < x1[j])
        oy = (y1[i] > y0[j]) & (y0[i] < y1[j])
        keep = (ax & ay) | (ox & oy)
        for a, b in zip(i[keep], j[keep]):
            out[int(a)].append(tiles[int(b)].tid)
    return out
