"""The golden fixture of the evaluation path, which the port's card check
is held against.

tests/fixtures/torch_port_golden_eval_v8n96.npz holds 8 seeded 96 px FITS
cutouts (their pixels and YOLO labels) and the JAX package's
evaluate_dataset outputs on them with the trained
tests/fixtures/yolov8n_synth96.npz in f32, in batches of 3 (the last one
partial): without preprocessing ("raw") and with
Pipeline([hist_equalizer(adaptive=True)]) ("clahe", the JAX engine's
Pallas CLAHE in interpret mode).  For each run: every image's merged
detections, the per-class completeness and reliability counts, F1, and
mAP50 / mAP50-95.  chip_smoke.py runs the port on the card against it
(CLAHE through kernel K7); these tests regenerate the JAX outputs so that
the fixture cannot go stale, and hold the port's CPU run to it.

Regenerate the fixture from the repository root with
    PYTHONPATH=. python tests/test_torch_eval_golden.py
"""

import json
import os
import tempfile

import numpy as np

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
GOLDEN = os.path.join(FIXTURES, "torch_port_golden_eval_v8n96.npz")
WEIGHTS = os.path.join(FIXTURES, "yolov8n_synth96.npz")
RUNS = ("raw", "clahe")
CONFIG = dict(img_size=96, score_thr=0.1, batch_size=3)
KEYS = ("source", "compact", "extended", "extended-multisland", "spurious",
        "flagged")
MAP_TOL = 1e-3


def make_set(root: str) -> list[str]:
    """8 seeded cutouts of 96 px with 1-3 class-1 sources each (the
    fixture weights' training distribution) and their labels."""
    from caesar_yolo_tpu_torch.utils.synth import write_labelled_cutouts
    return write_labelled_cutouts(root, 8, sizes=(96,), seed=700, label=1,
                                  noise_sigma=0.08, amp_range=(3.0, 8.0),
                                  sigma_range=(3.0, 6.0))


def write_set(root: str, golden: dict) -> list[str]:
    """The fixture's cutouts as FITS files and label txts under root."""
    from caesar_yolo_tpu_torch.utils.fits import write_fits
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "labels"), exist_ok=True)
    paths = []
    for i, (img, labels) in enumerate(zip(golden["images"],
                                          golden["labels"])):
        path = os.path.join(root, "images", f"c{i:03d}.fits")
        write_fits(img, path)
        with open(os.path.join(root, "labels", f"c{i:03d}.txt"), "w") as f:
            f.write(str(labels))
        paths.append(path)
    return paths


def _summarise(report, detail_path: str) -> dict:
    """Arrays of one evaluate_dataset run: merged detections of every image
    (from the per-image detail), counts, F1 and mAP."""
    from caesar_yolo_tpu_torch.outputs.catalog import CLASS_NAMES
    with open(detail_path) as f:
        detail = json.load(f)
    boxes, scores, cls, per_image = [], [], [], []
    for d in detail:
        per_image.append(len(d["pred"]))
        for p in d["pred"]:
            boxes.append(p["bbox"])
            scores.append(p["score"])
            cls.append(CLASS_NAMES.index(p["label"]))
    counts = np.asarray([[report.completeness[k].n,
                          report.completeness[k].n_matched,
                          report.reliability[k].n,
                          report.reliability[k].n_matched] for k in KEYS])
    return {"boxes": np.asarray(boxes, np.float64).reshape(-1, 4),
            "scores": np.asarray(scores, np.float64),
            "classes": np.asarray(cls, np.int64),
            "per_image": np.asarray(per_image, np.int64),
            "counts": counts,
            "f1": np.asarray([report.f1[k] for k in KEYS], np.float64),
            "maps": np.asarray([report.map.map50, report.map.map50_95])}


def jax_outputs(paths: list[str]) -> dict:
    """The reference's evaluate_dataset on the CPU in f32, per run."""
    import jax.numpy as jnp

    from caesar_yolo_tpu.evaluation import evaluate_dataset
    from caesar_yolo_tpu.models.convert import load_params
    from caesar_yolo_tpu.models.yolo import build_model
    from caesar_yolo_tpu.ops.transforms import Pipeline, hist_equalizer

    params, meta = load_params(WEIGHTS)
    model = build_model(meta["model"], num_classes=int(meta["num_classes"]))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for run in RUNS:
            pre = (Pipeline([hist_equalizer(adaptive=True)])
                   if run == "clahe" else None)
            detail = os.path.join(tmp, f"{run}.json")
            report = evaluate_dataset(model, params, paths, preprocessor=pre,
                                      compute_dtype=jnp.float32,
                                      detail_out=detail, **CONFIG)
            out.update({f"{run}_{k}": v for k, v in
                        _summarise(report, detail).items()})
    return out


def port_outputs(paths: list[str], device) -> dict:
    """The port's evaluate_dataset in f32 on `device`, per run."""
    import torch

    from caesar_yolo_tpu_torch.evaluation import evaluate_dataset
    from caesar_yolo_tpu_torch.models.convert import load_model
    from caesar_yolo_tpu_torch.ops.transforms import Pipeline, hist_equalizer

    model, _ = load_model(WEIGHTS)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for run in RUNS:
            pre = (Pipeline([hist_equalizer(adaptive=True)])
                   if run == "clahe" else None)
            detail = os.path.join(tmp, f"{run}.json")
            report = evaluate_dataset(model, paths, preprocessor=pre,
                                      compute_dtype=torch.float32,
                                      detail_out=detail, device=device,
                                      **CONFIG)
            out.update({f"{run}_{k}": v for k, v in
                        _summarise(report, detail).items()})
    return out


def golden_mismatch(golden: dict, got: dict) -> str | None:
    """The golden-eval rule: per image, the merged detections by the
    catalog rule (equal count, same class, IoU >= 0.99, score within
    1e-3); per class, equal completeness and reliability counts and F1;
    mAP50 and mAP50-95 within MAP_TOL.  None on a match, else what
    differs."""
    from caesar_yolo_tpu_torch.utils.boxes import catalog_mismatch
    for run in RUNS:
        g = {k: golden[f"{run}_{k}"] for k in ("boxes", "scores", "classes",
                                               "per_image")}
        o = {k: got[f"{run}_{k}"] for k in g}
        if not np.array_equal(o["per_image"], g["per_image"]):
            return (f"{run}: detections per image {o['per_image'].tolist()}"
                    f" != {g['per_image'].tolist()}")
        ends = np.cumsum(g["per_image"])
        for i, (a, b) in enumerate(zip(ends - g["per_image"], ends)):
            why = catalog_mismatch(
                (g["boxes"][a:b], g["scores"][a:b], g["classes"][a:b]),
                (o["boxes"][a:b], o["scores"][a:b], o["classes"][a:b]))
            if why:
                return f"{run} image {i}: {why}"
        if not np.array_equal(got[f"{run}_counts"], golden[f"{run}_counts"]):
            return (f"{run}: counts {got[f'{run}_counts'].tolist()} != "
                    f"{golden[f'{run}_counts'].tolist()}")
        if not np.array_equal(got[f"{run}_f1"], golden[f"{run}_f1"],
                              equal_nan=True):
            return f"{run}: F1 {got[f'{run}_f1']} != {golden[f'{run}_f1']}"
        err = np.abs(got[f"{run}_maps"] - golden[f"{run}_maps"]).max()
        if not err <= MAP_TOL:
            return f"{run}: mAP differs by {err:.3g} (limit {MAP_TOL})"
    return None


def load_golden() -> dict:
    with np.load(GOLDEN) as f:
        return {k: f[k] for k in f.files}


def test_fixture_matches_jax(tmp_path):
    golden = load_golden()
    ref = jax_outputs(write_set(str(tmp_path), golden))
    for run in RUNS:
        for k in ("per_image", "classes", "counts"):
            np.testing.assert_array_equal(ref[f"{run}_{k}"],
                                          golden[f"{run}_{k}"],
                                          err_msg=f"{run} {k}")
        # the same program on another CPU may round in other places
        for k in ("boxes", "scores", "f1", "maps"):
            np.testing.assert_allclose(ref[f"{run}_{k}"], golden[f"{run}_{k}"],
                                       atol=1e-4, rtol=0,
                                       err_msg=f"{run} {k}")
        assert golden[f"{run}_per_image"].sum() >= 8, run
        assert golden[f"{run}_counts"][0, 1] >= 3, run   # matched sources


def test_port_cpu_matches_fixture(tmp_path):
    """The port on the CPU in f32 against the fixture, by the golden-eval
    rule (the card runs the same check in chip_smoke.py)."""
    import torch
    torch.set_num_threads(1)
    golden = load_golden()
    got = port_outputs(write_set(str(tmp_path), golden), device="cpu")
    assert golden_mismatch(golden, got) is None, golden_mismatch(golden, got)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    with tempfile.TemporaryDirectory() as tmp:
        paths = make_set(tmp)
        from caesar_yolo_tpu_torch.utils.fits import read_fits
        images = np.stack([read_fits(p)[0] for p in paths]).astype(np.float32)
        labels = []
        for p in paths:
            lab = p.replace(f"{os.sep}images{os.sep}",
                            f"{os.sep}labels{os.sep}")[:-5] + ".txt"
            with open(lab) as f:
                labels.append(f.read())
        out = jax_outputs(paths)
    np.savez_compressed(GOLDEN, images=images, labels=np.asarray(labels),
                        **out)
    print(f"wrote {GOLDEN}: " + ", ".join(
        f"{run}: {int(out[f'{run}_per_image'].sum())} detections, "
        f"counts {out[f'{run}_counts'][0].tolist()}, maps "
        f"{out[f'{run}_maps'].tolist()}" for run in RUNS)
        + f"; {os.path.getsize(GOLDEN)} bytes")
