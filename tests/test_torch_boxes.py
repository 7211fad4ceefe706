"""The port's box helpers against the JAX package's on the CPU: get_iou,
xywh2xyxy and xyxy2xywh (caesar_yolo_tpu/utils/boxes.py) on the same 64
seeded boxes, degenerate and touching boxes included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caesar_yolo_tpu.utils import boxes as jboxes
from caesar_yolo_tpu_torch import utils as tutils
from caesar_yolo_tpu_torch.utils import boxes as tboxes

N = 64


def _xyxy(seed=0):
    """64 f32 xyxy boxes: 48 random ones of 1-80 px at offsets up to 200
    px, then 8 degenerate ones (zero width, zero height, x1 > x2, y1 > y2,
    a point) and 8 that touch the first eight along an edge or a corner
    (IoU 0 by the reference's rule)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 200, (48, 2))
    b = np.concatenate([xy, xy + rng.uniform(1, 80, (48, 2))], -1)
    d = b[:8].copy()
    d[0, 2] = d[0, 0]
    d[1, 3] = d[1, 1]
    d[2, [0, 2]] = d[2, [2, 0]]
    d[3, [1, 3]] = d[3, [3, 1]]
    d[4, 2:] = d[4, :2]
    d[5, [0, 2]] = d[5, [2, 0]]
    d[5, [1, 3]] = d[5, [3, 1]]
    d[6, 2] = d[6, 0] - 1e-3
    d[7, 3] = d[7, 1] - 1e-3
    t = b[:8].copy()
    w, h = t[:, 2] - t[:, 0], t[:, 3] - t[:, 1]
    t[:4, 0], t[:4, 2] = b[:4, 2], b[:4, 2] + w[:4]          # right edge
    t[4:6, 1], t[4:6, 3] = b[4:6, 3], b[4:6, 3] + h[4:6]     # bottom edge
    t[6:, 0], t[6:, 1] = b[6:8, 2], b[6:8, 3]                # corner
    t[6:, 2], t[6:, 3] = t[6:, 0] + w[6:], t[6:, 1] + h[6:]
    return np.concatenate([b, d, t]).astype(np.float32)


def _within_ulp(got, ref, n=1):
    """Elementwise |got - ref| <= n f32 ulps of the larger magnitude."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(ref)))
    return np.all(np.abs(got.astype(np.float64) - ref) <= n * ulp)


def test_get_iou_matches_jax_exactly():
    """get_iou over all 64 x 64 pairs equals the reference's bit for bit
    (both in float64 on the host); identical boxes give 1, degenerate and
    touching boxes 0."""
    b = _xyxy()
    got = np.array([[tboxes.get_iou(p, q) for q in b] for p in b])
    ref = np.array([[jboxes.get_iou(p, q) for q in b] for p in b])
    np.testing.assert_array_equal(got, ref)
    assert np.all(np.diag(got)[:48] == 1.0)
    assert np.all(got[48:56] == 0.0) and np.all(got[:, 48:56] == 0.0)
    assert np.all(got[np.arange(8), 56 + np.arange(8)] == 0.0)
    assert 0 < np.count_nonzero(got[:48, :48]) < 48 * 48


@pytest.mark.parametrize("name", ["xywh2xyxy", "xyxy2xywh"])
def test_box_conversion_matches_jax(name):
    """Each conversion of the 64 boxes (read as xywh for xywh2xyxy) is
    within 1 f32 ulp of the reference's, also over a leading batch
    axis."""
    x = _xyxy().reshape(2, N // 2, 4)
    got = getattr(tboxes, name)(torch.from_numpy(x))
    ref = getattr(jboxes, name)(jnp.asarray(x))
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert _within_ulp(got.numpy(), np.asarray(ref))


def test_box_round_trip_matches_jax():
    """xyxy2xywh(xywh2xyxy(b)) and the reverse round trip are each within 1
    f32 ulp of the reference's same round trip, and each box within 1 ulp
    of its largest coordinate of where it started (the sums round at the
    box's scale, not at each coordinate's)."""
    x = _xyxy()
    t = torch.from_numpy(x)
    j = jnp.asarray(x)
    for got, ref in (
            (tboxes.xyxy2xywh(tboxes.xywh2xyxy(t)),
             jboxes.xyxy2xywh(jboxes.xywh2xyxy(j))),
            (tboxes.xywh2xyxy(tboxes.xyxy2xywh(t)),
             jboxes.xywh2xyxy(jboxes.xyxy2xywh(j)))):
        assert _within_ulp(got.numpy(), np.asarray(ref))
        err = np.abs(got.numpy().astype(np.float64) - x)
        assert np.all(err <= np.spacing(np.abs(x).max(-1, keepdims=True)))


def test_box_helpers_exported_from_utils():
    """The package's utils exports the box helpers as the reference's
    utils/__init__.py does."""
    for name in ("get_iou", "get_merged_bbox", "iou_matrix",
                 "iou_matrix_np", "xywh2xyxy", "xyxy2xywh"):
        assert getattr(tutils, name) is getattr(tboxes, name)
