"""The golden fixture the port's card check is held against.

tests/fixtures/torch_port_golden_v8n96.npz holds a few seeded 96x96
synthetic tiles and the JAX TileEngine's f32 CPU outputs for them with
the trained tests/fixtures/yolov8n_synth96.npz and the README
preprocessing (zscale + min-max).  chip_smoke.py runs the port on the
card against it.  These tests regenerate the JAX outputs so that the
fixture cannot go stale, and hold the port's CPU run to it.

Regenerate the fixture from the repository root with
    PYTHONPATH=. python tests/test_torch_golden.py
"""

import os

import numpy as np

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
GOLDEN = os.path.join(FIXTURES, "torch_port_golden_v8n96.npz")
WEIGHTS = os.path.join(FIXTURES, "yolov8n_synth96.npz")
CONFIG = dict(img_size=96, score_thr=0.3, iou_thr=0.5, max_det=300,
              pre_nms=512)
KEYS = ("boxes", "scores", "class_ids", "valid", "tile_ok", "n_dropped")


def make_tiles(n: int = 6, size: int = 96) -> np.ndarray:
    """Seeded gray tiles [n, size, size, 1]: noise plus Gaussian sources
    like the training set's, and one all-zero (degenerate) tile."""
    from caesar_yolo_tpu_torch.utils.synth import make_mosaic
    tiles = np.stack([
        make_mosaic(size, size, n_sources=2 + i % 3, noise_sigma=0.08,
                    seed=100 + i, amp_range=(3.0, 8.0),
                    sigma_range=(2.5, 5.0))[0] for i in range(n)])
    tiles[n // 2] = 0.0
    return tiles[..., None]


def jax_outputs(tiles: np.ndarray) -> dict:
    """The reference's TileEngine on the CPU in f32."""
    import jax.numpy as jnp

    from caesar_yolo_tpu.models.convert import load_params
    from caesar_yolo_tpu.models.yolo import build_model
    from caesar_yolo_tpu.ops import build_preprocessor
    from caesar_yolo_tpu.parallel.engine import TileEngine

    params, meta = load_params(WEIGHTS)
    model = build_model(meta["model"], num_classes=int(meta["num_classes"]))
    engine = TileEngine(
        model, params, compute_dtype=jnp.float32,
        preprocessor=build_preprocessor(zscale_stretch=True,
                                        normalize_minmax=True),
        **CONFIG)
    return dict(zip(KEYS, engine.process(tiles)))


def load_golden() -> dict:
    with np.load(GOLDEN) as f:
        return {k: f[k] for k in f.files}


def test_fixture_matches_jax_engine():
    golden = load_golden()
    ref = jax_outputs(golden["tiles"])
    for k in ("class_ids", "valid", "tile_ok", "n_dropped"):
        np.testing.assert_array_equal(ref[k], golden[k], err_msg=k)
    # the same program on another CPU may round in other places
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(ref[k], golden[k], atol=1e-4, rtol=0,
                                   err_msg=k)
    assert golden["valid"].sum() >= 8
    assert not golden["tile_ok"][len(golden["tiles"]) // 2]


def test_port_cpu_matches_fixture():
    """The port's TileEngine on the CPU in f32 against the fixture, by the
    catalog rule (the card runs the same check in chip_smoke.py)."""
    import torch

    from caesar_yolo_tpu_torch.models.convert import load_model
    from caesar_yolo_tpu_torch.ops.transforms import build_preprocessor
    from caesar_yolo_tpu_torch.parallel.engine import TileEngine
    from caesar_yolo_tpu_torch.utils.boxes import catalog_mismatch

    torch.set_num_threads(1)
    golden = load_golden()
    model, _ = load_model(WEIGHTS)
    engine = TileEngine(
        model, device="cpu", compute_dtype=torch.float32,
        preprocessor=build_preprocessor(zscale_stretch=True,
                                        normalize_minmax=True),
        **CONFIG)
    got = dict(zip(KEYS, engine.process(golden["tiles"])))
    np.testing.assert_array_equal(got["tile_ok"], golden["tile_ok"])
    np.testing.assert_array_equal(got["n_dropped"], golden["n_dropped"])
    for i in range(len(golden["tiles"])):
        g, r = got["valid"][i], golden["valid"][i]
        assert catalog_mismatch(
            (golden["boxes"][i][r], golden["scores"][i][r],
             golden["class_ids"][i][r]),
            (got["boxes"][i][g], got["scores"][i][g],
             got["class_ids"][i][g])) is None, i


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    tiles = make_tiles()
    out = jax_outputs(tiles)
    np.savez_compressed(GOLDEN, tiles=tiles, **out)
    print(f"wrote {GOLDEN}: {int(out['valid'].sum())} detections, "
          f"tile_ok={out['tile_ok'].tolist()}, "
          f"{os.path.getsize(GOLDEN)} bytes")
