"""The port's serving artifact against the JAX package's, and loaded in a
process without the model code (caesar_yolo_tpu_torch/deploy.py).

Tolerances: the port's artifact against JAX's export_detector on the same
npz weights and tiles by the catalog rule in f32 (equal count, class, IoU
>= 0.99, score within 1e-3) and by the bf16 rule of
tests/test_torch_engine.py in bf16; the artifact in a fresh process equal
to the in-process one.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caesar_yolo_tpu.deploy import export_detector as jax_export_detector
from caesar_yolo_tpu.deploy import load_detector as jax_load_detector
from caesar_yolo_tpu.models.convert import load_params as jax_load_params
from caesar_yolo_tpu.models.yolo import build_model as jax_build_model
from caesar_yolo_tpu.ops import build_preprocessor as jax_build_preprocessor
from caesar_yolo_tpu_torch.deploy import export_detector, load_detector
from caesar_yolo_tpu_torch.models.convert import load_model
from caesar_yolo_tpu_torch.ops.transforms import build_preprocessor
from caesar_yolo_tpu_torch.utils.boxes import catalog_mismatch
from test_torch_deploy import README, REPO, _tiles, readme_blob  # noqa: F401
from test_torch_engine import BF16_MARGIN, _unpartnered
from test_torch_engine import _tiles as trained_tiles

torch.set_num_threads(1)

TRAINED = os.path.join(REPO, "tests", "fixtures", "yolov8n_synth96.npz")


@pytest.fixture(scope="module")
def trained():
    params, meta = jax_load_params(TRAINED)
    jm = jax_build_model(meta["model"], num_classes=int(meta["num_classes"]))
    return jm, params, load_model(TRAINED)[0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_artifact_matches_jax_artifact(trained, dtype):
    """JAX's export_detector and the port's, on the same npz weights and
    tiles: the catalog rule in f32, the bf16 rule in bf16."""
    jm, params, tm = trained
    tiles = trained_tiles(96)
    kw = dict(tile_shape=tiles.shape[1:], batch=len(tiles), img_size=96,
              score_thr=0.3, iou_thr=0.5)
    jdet = jax_load_detector(jax_export_detector(
        jm, params, preprocessor=jax_build_preprocessor(**README),
        compute_dtype=getattr(jnp, dtype), **kw))
    ref = [np.asarray(o) for o in jdet(jnp.asarray(tiles))]
    got = [o.numpy() for o in load_detector(export_detector(
        tm, preprocessor=build_preprocessor(**README), platforms="cpu",
        compute_dtype=getattr(torch, dtype), **kw))(tiles)]
    np.testing.assert_array_equal(got[4], ref[4])          # tile_ok
    np.testing.assert_array_equal(got[5], ref[5])          # n_dropped
    rb, rs, rc, rv = ref[:4]
    gb, gs, gc, gv = got[:4]
    assert rv.sum() >= 5
    for i in range(len(tiles)):
        r = (rb[i][rv[i]], rs[i][rv[i]], rc[i][rv[i]])
        g = (gb[i][gv[i]], gs[i][gv[i]], gc[i][gv[i]])
        if dtype == "float32":
            assert catalog_mismatch(r, g) is None, i
        else:
            thr = kw["score_thr"] + BF16_MARGIN
            assert not _unpartnered(r, g, thr), i
            assert not _unpartnered(g, r, thr), i


BLOCKER = """
import sys
BLOCKED = ("jax", "caesar_yolo_tpu", "caesar_yolo_tpu_torch.models.yolo",
           "caesar_yolo_tpu_torch.models.layers",
           "caesar_yolo_tpu_torch.ops.transforms",
           "caesar_yolo_tpu_torch.detect.predictor",
           "caesar_yolo_tpu_torch.parallel")

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Blocker())
import numpy as np
from caesar_yolo_tpu_torch.deploy import load_detector
det = load_detector(open(sys.argv[1], "rb").read())
out = det(np.load(sys.argv[2]))
np.savez(sys.argv[3], *[o.numpy() for o in out])
print(sorted(m for m in sys.modules if m.startswith("caesar_yolo_tpu")))
"""


def test_artifact_runs_without_model_code(readme_blob, tmp_path):
    """A process that cannot import JAX, the JAX package, the model, the
    preprocessing, the predictor or parallel/ loads the artifact through
    deploy.py and gets the in-process outputs."""
    tiles = _tiles(np.random.default_rng(42))
    art, npy, out = (tmp_path / n for n in ("det.cyx", "t.npy", "o.npz"))
    art.write_bytes(readme_blob)
    np.save(npy, tiles)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", BLOCKER, str(art), str(npy),
                           str(out)], capture_output=True, text=True,
                          env=env, timeout=300, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    loaded = proc.stdout.strip().splitlines()[-1]
    assert "models.yolo" not in loaded and "ops.transforms" not in loaded
    got = np.load(out)
    ref = load_detector(readme_blob)(tiles)
    for i, r in enumerate(ref):
        np.testing.assert_array_equal(got[f"arr_{i}"], r.numpy())
