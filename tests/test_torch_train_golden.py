"""The golden training run the port's card check is held against.

tests/fixtures/torch_port_golden_train_v8n96.npz holds a seeded batch of
four 96x96 gray tiles with their gt boxes, and what the JAX Trainer does
with it in f32 on the CPU from the trained tests/fixtures/yolov8n_synth96
weights, without augmentation: the loss and its three parts at each of 2
steps, the norm of every weight's update over the run, and the updated
weights of the head's final convs.  chip_smoke.py repeats the run on the
card in f32 (TF32 off).  These tests regenerate the JAX numbers, so that
the fixture cannot go stale, and hold the port's CPU run to it.

Step 0 leaves the weights (lr 0 at the first step of the warmup) and
fills the momentum trace; step 1 moves them by the gradients of both
steps, both taken at the initial weights, so the comparison sees no
amplification of rounding between steps.

Regenerate the fixture from the repository root with
    PYTHONPATH=. python tests/test_torch_train_golden.py
"""

import os

import numpy as np

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
GOLDEN = os.path.join(FIXTURES, "torch_port_golden_train_v8n96.npz")
WEIGHTS = os.path.join(FIXTURES, "yolov8n_synth96.npz")
CONFIG = dict(epochs=1, batch_size=4, img_size=96, compute_dtype="float32")
STEPS_PER_EPOCH = 2
STEPS = 2
FINAL_CONVS = [f"head/{branch}/{level}/2/{leaf}" for branch in ("box", "cls")
               for level in range(3) for leaf in ("w", "b")]
# port against the fixture: losses as f32 sums in another order; update
# norms and final-conv weights relative to the update's own scale (the
# gradients at equal weights agree within ~4e-5 of their norm)
LOSS_RTOL = 1e-4
UPDATE_RTOL = 1e-3


def make_batch(n: int = 4, size: int = 96, max_gt: int = 8):
    """Seeded gray tiles [n, size, size, 1] in [0, 1] (noise plus 1-3
    Gaussian sources) and their gt (labels, xyxy boxes, mask)."""
    from caesar_yolo_tpu_torch.utils.synth import make_mosaic
    tiles, labels = [], np.zeros((n, max_gt), np.int32)
    boxes = np.zeros((n, max_gt, 4), np.float32)
    mask = np.zeros((n, max_gt), bool)
    for i in range(n):
        img, gt = make_mosaic(size, size, n_sources=1 + i % 3,
                              noise_sigma=0.08, seed=200 + i,
                              amp_range=(3.0, 8.0), sigma_range=(2.5, 5.0))
        img = (img - img.min()) / (img.max() - img.min())
        tiles.append(img)
        k = len(gt)
        boxes[i, :k] = np.clip(gt, 0, size)
        labels[i, :k] = 1
        mask[i, :k] = True
    return np.stack(tiles)[..., None].astype(np.float32), labels, boxes, mask


def as_train_batch(golden):
    """The fixture's batch as the trainer takes it (gray -> 3 channels)."""
    return (np.repeat(golden["tiles"], 3, axis=-1), golden["labels"],
            golden["boxes"], golden["mask"])


def summarise(init: dict, final: dict, losses) -> dict:
    """{loss, parts, update norms, final-conv weights} of a run, from flat
    {param path: array} dicts of the initial and final weights (the final
    convs the model has: a YOLO11 head's class branch ends in a Conv with
    BN, without a bias)."""
    keys = sorted(k for k in init if not k.endswith(("/mean", "/var")))
    out = {"loss": np.asarray([l for l, _ in losses], np.float32),
           "parts": np.asarray([[p[k] for k in ("box", "cls", "dfl")]
                                for _, p in losses], np.float32),
           "norm_keys": np.asarray(keys),
           "update_norms": np.asarray(
               [np.linalg.norm(np.asarray(final[k]) - np.asarray(init[k]))
                for k in keys], np.float32)}
    for k in FINAL_CONVS:
        if k in final:
            out["final/" + k] = np.asarray(final[k], np.float32)
    return out


def jax_run(golden) -> dict:
    """The reference's Trainer on the CPU in f32."""
    import jax

    from caesar_yolo_tpu.models.convert import _flatten, load_params
    from caesar_yolo_tpu.models.yolo import build_model
    from caesar_yolo_tpu.train import TrainConfig, Trainer

    params, meta = load_params(WEIGHTS)
    model = build_model(meta["model"], num_classes=int(meta["num_classes"]))
    trainer = Trainer(model, params, TrainConfig(**CONFIG),
                      steps_per_epoch=STEPS_PER_EPOCH)
    losses = []
    for _ in range(STEPS):
        loss, parts = trainer.train_step(*as_train_batch(golden))
        losses.append((float(loss), {k: float(v) for k, v in parts.items()}))
    return summarise(dict(_flatten(params)),
                     dict(_flatten(jax.device_get(trainer.state.params))),
                     losses)


def port_run(golden, device="cpu") -> dict:
    """The port's Trainer on `device` in f32 (the caller sets TF32 off on
    CUDA)."""
    from caesar_yolo_tpu_torch.models.convert import flat_params, load_model
    from caesar_yolo_tpu_torch.train.trainer import TrainConfig, Trainer

    model, _ = load_model(WEIGHTS)
    init = flat_params(model.state_dict())
    trainer = Trainer(model, TrainConfig(**CONFIG),
                      steps_per_epoch=STEPS_PER_EPOCH, device=device)
    losses = []
    for _ in range(STEPS):
        loss, parts = trainer.train_step(*as_train_batch(golden))
        losses.append((loss.item(), {k: v.item() for k, v in parts.items()}))
    return summarise(init, flat_params(trainer.model.state_dict()), losses)


def golden_mismatch(golden, got) -> str | None:
    """None when a run agrees with the fixture by the stated tolerances,
    else what differs (chip_smoke.py applies it to the card's run)."""
    for k in ("loss", "parts"):
        err = np.abs(got[k] - golden[k]) / np.abs(golden[k])
        if not (err <= LOSS_RTOL).all():
            return f"{k}: relative error {err.max():.3g} > {LOSS_RTOL}"
    if list(got["norm_keys"]) != list(golden["norm_keys"]):
        return "parameter names differ"
    ref = golden["update_norms"]
    err = np.abs(got["update_norms"] - ref)
    bad = err > UPDATE_RTOL * ref + 1e-9
    if bad.any():
        return (f"update norm of {golden['norm_keys'][bad.argmax()]}: "
                f"{got['update_norms'][bad.argmax()]:.6g} vs "
                f"{ref[bad.argmax()]:.6g}")
    norms = dict(zip(golden["norm_keys"], ref))
    finals = sorted(k for k in golden if k.startswith("final/"))
    if finals != sorted(k for k in got if k.startswith("final/")):
        return "final convs differ"
    for key in finals:
        k = key[len("final/"):]
        r, g = golden[key], got[key]
        scale = norms[k] / np.sqrt(r.size)          # rms of the update
        err = np.abs(g - r).max()
        if err > UPDATE_RTOL * 30 * scale + 4 * np.spacing(np.abs(r).max()):
            return f"{k}: max abs err {err:.3g} (update rms {scale:.3g})"
    return None


def load_golden() -> dict:
    with np.load(GOLDEN) as f:
        return {k: f[k] for k in f.files}


def test_fixture_matches_jax_trainer():
    """The committed numbers are the JAX Trainer's on this tree: losses
    within 1e-6 relative, update norms within 1e-5 relative and the head's
    final weights within 1e-6 (the same program on another CPU may round
    in other places)."""
    golden = load_golden()
    ref = jax_run(golden)
    for k in ("loss", "parts"):
        np.testing.assert_allclose(ref[k], golden[k], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(ref["norm_keys"], golden["norm_keys"])
    np.testing.assert_allclose(ref["update_norms"], golden["update_norms"],
                               rtol=1e-5, atol=1e-10)
    for k in FINAL_CONVS:
        np.testing.assert_allclose(ref["final/" + k], golden["final/" + k],
                                   rtol=0, atol=1e-6, err_msg=k)
    assert (golden["update_norms"] > 0).sum() > 100
    assert golden["mask"].sum() >= 6


def test_port_cpu_matches_fixture():
    """The port's Trainer on the CPU against the fixture, by the rule the
    card run uses (golden_mismatch)."""
    golden = load_golden()
    assert golden_mismatch(golden, port_run(golden)) is None


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    tiles, labels, boxes, mask = make_batch()
    batch = dict(tiles=tiles, labels=labels, boxes=boxes, mask=mask)
    out = jax_run(batch)
    np.savez_compressed(GOLDEN, **batch, **out)
    print(f"wrote {GOLDEN}: losses {out['loss'].tolist()}, "
          f"{os.path.getsize(GOLDEN)} bytes")
