"""The 640 px bf16 golden fixture of the trained five-class model, which
the port's bf16 on the card is held against, and the trained model's f32
parity on the CPU.

tests/fixtures/torch_port_golden_bf16_q5.npz holds 16 seeded five-class
cutouts of 132 px (utils/synth5.py, seed GOLDEN_SEED) and the JAX
package's Predictor outputs on them in bf16 at 640 px with the trained
tests/fixtures/torch_quality5_v8n.npz (score 0.25, IoU 0.5): every slot's
boxes, scores, classes and valid flags, and the mean class logit of each
stride over all anchors and images.  chip_smoke.py runs the port's bf16
Predictor on the card against it by ROADMAP's bf16 rule (`bf16_mismatch`:
each detection clear of the threshold by 0.03 has a same-class partner
with IoU >= 0.5 and a score within 0.025, both ways; each stride's mean
class logit within 4e-3); these tests regenerate the JAX outputs so that
the fixture cannot go stale and hold the port's CPU bf16 to it by the
same rule.

Regenerate the fixture from the repository root with
    PYTHONPATH=. python tests/test_torch_golden_bf16.py
"""

import os

import numpy as np

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
GOLDEN = os.path.join(FIXTURES, "torch_port_golden_bf16_q5.npz")
WEIGHTS = os.path.join(FIXTURES, "torch_quality5_v8n.npz")
GOLDEN_SEED = 40_000_000
N_IMAGES = 16
CONFIG = dict(img_size=640, score_thr=0.25, iou_thr=0.5)
# ROADMAP's bf16 rule (tests/test_torch_engine.py, tests/test_torch_models.py)
BF16_MARGIN, BF16_IOU, BF16_SCORE_TOL, LOGIT_MEAN_TOL = 0.03, 0.5, 0.025, 4e-3


def make_images() -> np.ndarray:
    """The fixture's cutouts [16, 132, 132, 3] f32 (the port's render on
    the CPU from GOLDEN_SEED)."""
    from caesar_yolo_tpu_torch.utils.synth5 import make_multiclass_batch
    return make_multiclass_batch(GOLDEN_SEED, N_IMAGES,
                                 device="cpu")[0].numpy()


def jax_outputs(images: np.ndarray, dtype: str = "bfloat16") -> dict:
    """The JAX Predictor's outputs on the CPU, and each stride's mean class
    logit of the fused model's forward on the letterboxed batch."""
    import jax.numpy as jnp

    from caesar_yolo_tpu.detect.letterbox import letterbox_batch
    from caesar_yolo_tpu.detect.predictor import Predictor
    from caesar_yolo_tpu.models.convert import load_params
    from caesar_yolo_tpu.models.yolo import build_model
    from caesar_yolo_tpu.parallel.engine import fuse_model_params

    params, meta = load_params(WEIGHTS)
    model = build_model(meta["model"], num_classes=int(meta["num_classes"]))
    dt = getattr(jnp, dtype)
    pred = Predictor(model, params, compute_dtype=dt, **CONFIG)
    boxes, scores, cls, valid, _ = (np.asarray(v) for v in
                                    pred.predict_batch(images))
    x = letterbox_batch(jnp.asarray(images), CONFIG["img_size"]).astype(dt)
    raw = model(fuse_model_params(model, params), x)
    means = np.asarray([float(np.asarray(c, np.float64).mean())
                        for _, c in raw])
    return {"boxes": boxes, "scores": scores, "classes": cls,
            "valid": valid, "cls_mean": means}


def port_outputs(images: np.ndarray, device, dtype=None) -> dict:
    """The port's Predictor outputs and stride means (as jax_outputs) on
    `device`, in bf16 unless `dtype` says otherwise."""
    import torch

    from caesar_yolo_tpu_torch.detect.letterbox import letterbox_nchw
    from caesar_yolo_tpu_torch.detect.predictor import Predictor
    from caesar_yolo_tpu_torch.models.convert import load_model

    dtype = dtype or torch.bfloat16
    model, _ = load_model(WEIGHTS)
    pred = Predictor(model, compute_dtype=dtype, device=device, **CONFIG)
    boxes, scores, cls, valid, _ = (t.cpu().numpy() for t in
                                    pred.predict_batch(images))
    x = torch.from_numpy(images).to(pred.device).permute(0, 3, 1, 2)
    x = letterbox_nchw(x, CONFIG["img_size"]).to(dtype)
    if x.is_cuda:
        x = x.contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        raw = pred.model(x)
    means = np.asarray([float(c.double().mean()) for _, c in raw])
    return {"boxes": boxes, "scores": scores, "classes": cls,
            "valid": valid, "cls_mean": means}


def _unpartnered(a, b, thr):
    from caesar_yolo_tpu_torch.utils.boxes import iou_matrix_np
    lonely = []
    for j in np.nonzero(a[1] >= thr)[0]:
        iou = iou_matrix_np(a[0][j:j + 1], b[0].reshape(-1, 4))[0]
        if not ((iou >= BF16_IOU) & (b[2] == a[2][j])
                & (np.abs(b[1] - a[1][j]) <= BF16_SCORE_TOL)).any():
            lonely.append((a[0][j].tolist(), float(a[1][j])))
    return lonely


def detection_mismatch(golden: dict, got: dict) -> str | None:
    """The first part of ROADMAP's bf16 rule: per image and both ways,
    each detection clear of the threshold by BF16_MARGIN has a same-class
    partner with IoU >= BF16_IOU and a score within BF16_SCORE_TOL."""
    thr = CONFIG["score_thr"] + BF16_MARGIN
    for i in range(len(golden["valid"])):
        sides = []
        for d in (golden, got):
            v = np.asarray(d["valid"][i], bool)
            sides.append((np.asarray(d["boxes"][i])[v],
                          np.asarray(d["scores"][i])[v],
                          np.asarray(d["classes"][i])[v]))
        for a, b, what in ((sides[0], sides[1], "reference"),
                           (sides[1], sides[0], "port")):
            lonely = _unpartnered(a, b, thr)
            if lonely:
                return f"image {i}: {what} detections without a partner " \
                       f"{lonely}"
    return None


def logit_gaps(golden: dict, got: dict) -> np.ndarray:
    """|port - reference| of each stride's mean class logit (the second
    part of the rule holds each within LOGIT_MEAN_TOL)."""
    return np.abs(np.asarray(got["cls_mean"]) - golden["cls_mean"])


def bf16_mismatch(golden: dict, got: dict) -> str | None:
    """ROADMAP's bf16 rule, both parts.  None on a match, else what
    differs."""
    why = detection_mismatch(golden, got)
    if why:
        return why
    gap = logit_gaps(golden, got)
    if not (gap <= LOGIT_MEAN_TOL).all():
        return f"mean class logits differ by {gap.tolist()}"
    return None


def load_golden() -> dict:
    with np.load(GOLDEN) as f:
        return {k: f[k] for k in f.files}


def test_fixture_matches_jax():
    golden = load_golden()
    np.testing.assert_array_equal(golden["images"], make_images())
    ref = jax_outputs(golden["images"])
    for k in ("valid", "classes"):
        np.testing.assert_array_equal(ref[k], golden[k], err_msg=k)
    # the same program on another CPU may round in other places
    for k in ("boxes", "scores", "cls_mean"):
        np.testing.assert_allclose(ref[k], golden[k], atol=1e-4, rtol=0,
                                   err_msg=k)
    assert golden["valid"].sum() >= N_IMAGES


def test_port_cpu_bf16_matches_fixture():
    """The port's bf16 on the CPU against the fixture by the whole bf16
    rule: every detection partnered both ways and each stride's mean class
    logit within LOGIT_MEAN_TOL (measured 2.0e-4, 1.2e-4, 1.6e-4, once the
    port rounded once after the f32 bias and took the reference's SiLU;
    0.0135, 0.0167, 0.0003 before).  The card runs the same check in
    chip_smoke.py."""
    import torch
    torch.set_num_threads(1)
    golden = load_golden()
    got = port_outputs(golden["images"], "cpu")
    why = bf16_mismatch(golden, got)
    assert why is None, why
    assert (logit_gaps(golden, got) <= LOGIT_MEAN_TOL).all()


def test_trained_model_f32_matches_jax():
    """The trained five-class model's f32 Predictors, JAX's and the
    port's, on 8 held-out cutouts at 640 px: per image by the catalog rule
    (equal count, same class, IoU >= 0.99, score within 1e-3)."""
    import torch

    from caesar_yolo_tpu_torch.utils.boxes import catalog_mismatch
    torch.set_num_threads(1)
    images = load_golden()["images"][:8]
    ref = jax_outputs(images, "float32")
    got = port_outputs(images, "cpu", torch.float32)
    n = 0
    for i in range(len(images)):
        r, g = ({k: d[k][i] for k in d if k != "cls_mean"}
                for d in (ref, got))
        arrays = [(d["boxes"][d["valid"]], d["scores"][d["valid"]],
                   d["classes"][d["valid"]]) for d in (r, g)]
        assert catalog_mismatch(*arrays) is None, (i, catalog_mismatch(
            *arrays))
        n += int(r["valid"].sum())
    assert n >= 8
    assert np.abs(ref["cls_mean"] - got["cls_mean"]).max() <= 1e-4


if __name__ == "__main__":
    images = make_images()
    out = jax_outputs(images)
    np.savez_compressed(GOLDEN, images=images, **out)
    print(f"wrote {GOLDEN}: {int(out['valid'].sum())} detections on "
          f"{N_IMAGES} cutouts; stride means {out['cls_mean'].tolist()}")
