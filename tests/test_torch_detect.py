"""The PyTorch port's NMS (K1's plain version), letterbox, merge and box
math against the JAX package, on the CPU with the same seeded inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import caesar_yolo_tpu.detect.pallas_nms as jax_pallas_nms
from caesar_yolo_tpu.detect import nms as jax_nms
from caesar_yolo_tpu.detect.letterbox import letterbox_batch as jax_letterbox
from caesar_yolo_tpu.detect.letterbox import (
    unletterbox_boxes as jax_unletterbox)
from caesar_yolo_tpu.detect.merge import merge_detections as jax_merge
from caesar_yolo_tpu.utils.boxes import iou_matrix as jax_iou_matrix
from caesar_yolo_tpu_torch.detect import cuda_nms
from caesar_yolo_tpu_torch.detect.letterbox import (
    letterbox_batch,
    unletterbox_boxes,
)
from caesar_yolo_tpu_torch.detect.merge import merge_detections
from caesar_yolo_tpu_torch.detect.nms import nms_batch
from caesar_yolo_tpu_torch.utils.boxes import iou_matrix

torch.set_num_threads(1)


def _candidates(rng, b, k, spread):
    """Score-sorted candidates as _select_candidates hands them over:
    [B, K, 4] xyxy plus a valid mask with holes and trailing invalids."""
    cx = rng.random((b, k)) * spread
    cy = rng.random((b, k)) * spread
    w = rng.random((b, k)) * 30 + 2
    h = rng.random((b, k)) * 30 + 2
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                     axis=-1).astype(np.float32)
    boxes[:, 10:14] = boxes[:, 9:10]           # identical boxes
    valid = rng.random((b, k)) > 0.1
    valid[:, -3:] = False
    return boxes, valid


@pytest.mark.parametrize("spread", [120.0, 25.0])
@pytest.mark.parametrize("iou_thr", [0.3, 0.5, 0.7])
def test_suppress_plain_matches_xla_and_pallas(monkeypatch, spread,
                                               iou_thr):
    """K1's plain version against the reference's XLA sweeps and its
    Pallas kernel in interpret mode at K=128: masks bit-equal."""
    monkeypatch.setattr(jax_pallas_nms, "INTERPRET", True)
    boxes, valid = _candidates(np.random.default_rng(7), 2, 128, spread)
    ref = np.asarray(jax.vmap(
        lambda nb, tv: jax_nms._suppress_xla(nb, tv, iou_thr))(
            jnp.asarray(boxes), jnp.asarray(valid)))
    pallas = np.asarray(jax_pallas_nms.nms_suppress(
        jnp.asarray(boxes.transpose(0, 2, 1)), jnp.asarray(valid), iou_thr))
    got = cuda_nms.nms_suppress(torch.from_numpy(boxes.transpose(0, 2, 1)),
                                torch.from_numpy(valid), iou_thr).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pallas)
    assert 0 < got.sum() < valid.sum()


def test_iou_matrix_bit_equal():
    boxes, _ = _candidates(np.random.default_rng(3), 1, 64, 40.0)
    np.testing.assert_array_equal(
        iou_matrix(torch.from_numpy(boxes[0]), torch.from_numpy(boxes[0])
                   ).numpy(),
        np.asarray(jax_iou_matrix(jnp.asarray(boxes[0]),
                                  jnp.asarray(boxes[0]))))


def _detections(rng, b, a, nc, spread, tied):
    cx = rng.random((b, a)) * spread
    cy = rng.random((b, a)) * spread
    wh = rng.random((b, a, 2)) * 20 + 2
    boxes = np.stack([cx - wh[..., 0] / 2, cy - wh[..., 1] / 2,
                      cx + wh[..., 0] / 2, cy + wh[..., 1] / 2],
                     axis=-1).astype(np.float32)
    scores = rng.random((b, a, nc)).astype(np.float32)
    if tied:
        # coarse score levels: many exact ties, broken by anchor index
        scores = np.round(scores * 8) / 8
    return boxes, scores


@pytest.mark.parametrize("case,pre_nms,max_det", [
    ("random", 512, 300),
    ("tied", 512, 300),
    ("crowded", 64, 30),
])
def test_nms_batch_exactly_equal(case, pre_nms, max_det):
    """nms_batch outputs and n_dropped are exactly the reference's."""
    rng = np.random.default_rng({"random": 0, "tied": 1, "crowded": 2}[case])
    boxes, scores = _detections(rng, 3, 600, 5,
                                30.0 if case == "crowded" else 300.0,
                                tied=case == "tied")
    kw = dict(conf_thr=0.25, iou_thr=0.5, max_det=max_det, pre_nms=pre_nms)
    ref = jax_nms.nms_batch(jnp.asarray(boxes), jnp.asarray(scores), **kw)
    got = nms_batch(torch.from_numpy(boxes), torch.from_numpy(scores), **kw)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    if case == "crowded":
        assert (got[4].numpy() > 0).all()
        assert got[3].numpy().sum(axis=1).max() == max_det


@pytest.mark.parametrize("size", [40, 96, 150])
def test_letterbox_matches_jax(size):
    """Upscale (40 and 96 px tiles) and downscale (150 px) to 128 px
    against the reference's jax.image.resize letterbox within 1e-5."""
    rng = np.random.default_rng(size)
    img = rng.random((2, size, size + 10, 3), dtype=np.float32)
    ref = np.asarray(jax_letterbox(jnp.asarray(img), 128))
    got = letterbox_batch(torch.from_numpy(img), 128).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    boxes = (rng.random((2, 7, 4)) * 140 - 6).astype(np.float32)
    np.testing.assert_allclose(
        unletterbox_boxes(torch.from_numpy(boxes), size, size + 10,
                          128).numpy(),
        np.asarray(jax_unletterbox(jnp.asarray(boxes), size, size + 10,
                                   128)), atol=1e-5, rtol=0)


def test_merge_matches_jax():
    rng = np.random.default_rng(5)
    boxes, _ = _candidates(rng, 1, 40, 60.0)
    scores = rng.random(40)
    cls = rng.integers(0, 3, 40)
    for r, g in zip(jax_merge(boxes[0], scores, cls),
                    merge_detections(boxes[0], scores, cls)):
        np.testing.assert_array_equal(g, r)
