"""The port's multi-process runs on the CPU: torch.distributed over gloo,
each rank a subprocess (tests/torch_mp_worker.py) joined by a file://
rendezvous under tmp_path.  The twins of tests/test_multiprocess.py:

  - two-rank training against one process on the same global batch, and
    against the JAX Trainer's numbers on it (the golden-train fixture,
    which test_torch_train_golden holds to a live JAX run);
  - a two-rank tiled run whose gather takes several rounds, against the
    one-process run and the JAX SFinder's catalog (the golden mosaic
    fixture, held to a live JAX run by test_torch_sfinder);
  - four ranks over three tiles through cli.run: the fourth rank has no
    tile and still joins every gather round;

and in-process checks of what they rest on: synchronized BatchNorm and
the chunked allgather (two ranks), the per-rank spool name and the stripe
in the grid signature against the JAX SFinder's, and the default device
under a group.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_torch_train_golden as golden_train
import torch_mp_worker
from caesar_yolo_tpu_torch.parallel import mesh
from caesar_yolo_tpu_torch.utils.boxes import catalog_mismatch
from caesar_yolo_tpu_torch.utils.fits import write_fits
from test_torch_sfinder import (
    CONFIG as MOSAIC_CONFIG,
    PREPROC as MOSAIC_PREPROC,
    catalog_arrays,
    golden_arrays,
    load_golden as load_golden_mosaic,
)

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_mp_worker.py")
WEIGHTS = os.path.join(HERE, "fixtures", "yolov8n_synth96.npz")
# a rank waits at most this long for its peers in a collective, and the
# test at most LAUNCH_TIMEOUT_S for all ranks
GROUP_TIMEOUT_S = 120
LAUNCH_TIMEOUT_S = 240


def launch(tmp_path, spec: dict, world: int) -> list[dict]:
    """Run `spec` on `world` gloo ranks (subprocesses) -> each rank's
    result, in rank order."""
    spec = dict(spec, world=world, out=str(tmp_path), device="cpu",
                init=f"file://{tmp_path}/rendezvous_{spec['mode']}_{world}",
                backend="gloo", timeout_s=GROUP_TIMEOUT_S, threads=1)
    path = tmp_path / f"spec_{spec['mode']}_{world}.json"
    path.write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, str(path), str(r)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=LAUNCH_TIMEOUT_S)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-3000:]}"
    return [json.loads((tmp_path / f"{spec['mode']}_rank{r}_n{world}.json")
                       .read_text()) for r in range(world)]


def as_summary(d: dict) -> dict:
    """A worker's golden-train summary (JSON lists) as the f32 arrays
    summarise made."""
    return {k: np.asarray(v) if k == "norm_keys"
            else np.asarray(v, np.float32) for k, v in d.items()}


def test_two_rank_training_matches_one_process(tmp_path):
    """Two ranks train on the golden batch split 2 + 2 for three f32
    steps: both hold the same weights and EMA bit for bit and report the
    same losses; losses and weight and EMA sums agree with one process on
    the whole batch within rtol 1e-5 (measured: within 2e-7); and the first
    two steps agree with the JAX Trainer's on the whole batch by the
    golden-train rule."""
    spec = dict(mode="train", weights=WEIGHTS, batch="golden", steps=3,
                summary_after=golden_train.STEPS, compute_dtype="float32")
    r0, r1 = launch(tmp_path, spec, 2)
    one = torch_mp_worker.run_train(spec, 0, "cpu")

    assert r0["params_hash"] == r1["params_hash"]
    assert r0["ema_hash"] == r1["ema_hash"]
    assert r0["losses"] == r1["losses"]
    assert r0["step"] == r1["step"] == one["step"] == 3
    assert r0["world"] == 2 and r0["backend"] == "gloo"
    np.testing.assert_allclose(r0["losses"], one["losses"], rtol=1e-5)
    np.testing.assert_allclose(r0["param_sums"], one["param_sums"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(r0["ema_sums"], one["ema_sums"],
                               rtol=1e-5, atol=1e-6)
    golden = golden_train.load_golden()
    bad = golden_train.golden_mismatch(golden, as_summary(r0["summary"]))
    assert bad is None, bad


def test_two_rank_training_cli_matches_one_process(tmp_path):
    """cli.train on two ranks (yolo11n at 64 px, a global batch of 4,
    augmented, 2 epochs of 2 steps, validation on rank 0 after each epoch
    with precise-BN on both ranks): the same weights and EMA on both ranks
    bit for bit, rank 0's checkpoints alone on disk, and the run the
    one-process run by the port's training rules: losses within the
    golden-train rule's 1e-4 (measured: 4.8e-5 at the third step, the
    first after a validation), each leaf of the final weights, EMA and BN
    statistics within test_torch_train's per-leaf tolerance (2% of the
    leaf's motion; this tiny batch amplifies ulps from step to step)."""
    from caesar_yolo_tpu_torch.cli import train as cli_train
    from caesar_yolo_tpu_torch.models.yolo import build_model, init_weights
    from test_torch_train import _leaf_tol, _write_dataset

    data = _write_dataset(tmp_path / "d", n=8, yaml_val=True)
    args = [f"--data={data}", "--devices=cpu", "--model=yolo11n",
            "--num_classes=2", "--imgsz=64", "--batch=4", "--epochs=2",
            "--fp32", "--max_gt=4", "--val_every=1",
            "--val_score_thr=0.001", "--checkpoint_every=1"]
    ck = tmp_path / "ck2"
    r0, r1 = launch(tmp_path, dict(mode="cli_train", argv=args + [
        f"--checkpoint_dir={ck}"]), 2)
    rc, one = cli_train.run(args + [f"--checkpoint_dir={tmp_path / 'ck1'}"])

    assert r0["rc"] == r1["rc"] == rc == 0
    assert r0["step"] == r1["step"] == one.step == 4
    assert r0["params_hash"] == r1["params_hash"]
    assert r0["ema_hash"] == r1["ema_hash"]
    assert r0["losses"] == r1["losses"]
    assert r0["best_metric"] == r1["best_metric"] == one.best_metric
    np.testing.assert_allclose(r0["losses"],
                               [float(v) for _, v in one.loss_log],
                               rtol=golden_train.LOSS_RTOL)
    assert sorted(os.listdir(ck)) == sorted(os.listdir(tmp_path / "ck1"))
    last = torch.load(ck / "last", map_location="cpu", weights_only=True)
    assert torch_mp_worker.digest(last["params"])[0] == r0["params_hash"]
    assert torch_mp_worker.digest(last["ema_params"])[0] == r0["ema_hash"]
    init = init_weights(build_model("yolo11n", num_classes=2),
                        seed=0).state_dict()
    for key, ref in (("params", one.model.state_dict()),
                     ("ema_params", one.ema)):
        for k, v in ref.items():
            r, a = v.numpy(), last[key][k].numpy()
            assert np.abs(a - r).max() <= _leaf_tol(r, init[k].numpy()), k


def _tiled_spec(path: str, workdir) -> dict:
    os.makedirs(workdir, exist_ok=True)
    return dict(mode="tiled", weights=WEIGHTS, preproc=MOSAIC_PREPROC,
                compute_dtype="float32", workdir=str(workdir),
                sfinder=dict(MOSAIC_CONFIG, image_path=path))


def test_two_rank_tiled_run(tmp_path):
    """The golden mosaic (nine tiles in four shapes, NaN borders, an all-
    zero tile, a source stitched across four tiles) on two ranks with a
    256-byte gather chunk: ranks 5 + 4 tiles, several gather rounds, the
    same catalog on both, rank 0 the only writer, no spool left; the
    catalog equals the one-process run's and the JAX SFinder's by the
    catalog rule with equal edge and merged flags."""
    golden = load_golden_mosaic()
    path = str(tmp_path / "mosaic.fits")
    write_fits(golden["mosaic"], path)
    spec = dict(_tiled_spec(path, tmp_path / "ranks"),
                gather_payload_bytes=256)
    r0, r1 = launch(tmp_path, spec, 2)
    one = torch_mp_worker.run_tiled(_tiled_spec(path, tmp_path / "one"), 0,
                                    "cpu")

    assert r0["rc"] == r1["rc"] == one["rc"] == 0
    assert r0["n_tiles"] == r1["n_tiles"] == 9
    assert [r0["n_local_tiles"], r1["n_local_tiles"]] == [5, 4]
    assert r0["gather_rounds"] == r1["gather_rounds"] >= 2
    assert r0["gather_bytes"] > 256 and r1["gather_bytes"] > 256
    assert one["gather_rounds"] == 0
    assert r0["sources"] == r1["sources"]
    assert r0["sources"] == one["sources"]
    files = sorted(os.listdir(tmp_path / "ranks"))
    assert files == ["catalog_mosaic.json", "ds9_mosaic.reg"], files
    cat = json.loads((tmp_path / "ranks" / "catalog_mosaic.json").read_text())
    assert cat["sources"] == r0["sources"]
    ref = golden_arrays(golden)
    bad = catalog_mismatch(ref, catalog_arrays(r0["sources"]))
    assert bad is None, bad
    assert any(s["merged"] for s in r0["sources"])


def _write_strip(path: str) -> None:
    """96 x 288 px: three 96 px tiles at step 1, a source at each centre
    (tests/test_multiprocess.py's strip)."""
    rng = np.random.default_rng(1)
    img = rng.normal(0.0, 0.08, (96, 288)).astype(np.float32)
    yy, xx = np.mgrid[0:96, 0:288]
    for cx in (48, 144, 240):
        img += 6.0 * np.exp(-((xx - cx) ** 2 + (yy - 48) ** 2)
                            / (2 * 4.5 ** 2)).astype(np.float32)
    write_fits(img, path)


def test_four_rank_uneven_striping(tmp_path):
    """cli.run on four ranks over three tiles with a 64-byte gather chunk:
    rank 3 holds no tile and still joins every round; every rank ends with
    the same three-source catalog, which rank 0 alone writes."""
    path = str(tmp_path / "strip.fits")
    _write_strip(path)
    workdir = tmp_path / "run"
    workdir.mkdir()
    argv = [f"--image={path}", f"--weights={WEIGHTS}", "--imgsize=96",
            "--devices=cpu", "--scoreThr=0.3", "--preprocessing",
            "--normalize_minmax", "--split_img_in_tiles", "--tile_xsize=96",
            "--tile_ysize=96", "--tile_xstep=1", "--tile_ystep=1",
            "--batch_size=4"]
    ranks = launch(tmp_path, dict(mode="tiled", workdir=str(workdir),
                                  argv=argv, gather_payload_bytes=64), 4)
    assert all(r["rc"] == 0 and r["n_tiles"] == 3 for r in ranks)
    assert [r["n_local_tiles"] for r in ranks] == [1, 1, 1, 0]
    # rank 3 sends the JSON of no results, "[]"
    assert [r["gather_bytes"] > 2 for r in ranks] == [True] * 3 + [False]
    assert all(r["gather_rounds"] >= 3 for r in ranks)
    assert len({r["gather_rounds"] for r in ranks}) == 1
    for r in ranks[1:]:
        assert r["sources"] == ranks[0]["sources"]
    assert len(ranks[0]["sources"]) == 3
    assert sorted(os.listdir(workdir)) == ["catalog_strip.json",
                                           "ds9_strip.reg"]
    cat = json.loads((workdir / "catalog_strip.json").read_text())
    assert cat["sources"] == ranks[0]["sources"]


def test_synchronized_batchnorm_and_gather(tmp_path):
    """Two ranks, four rows each: the Conv's train-mode output and input
    gradient equal those of one process on the eight rows, with BN's
    statistics over all eight (var_mean of the concatenated batch); the
    ranks' weight gradients sum to its.  allgather_bytes returns every
    rank's payload, rank 1's empty, in ceil(200 / 64) = 4 rounds, and
    nothing in 0 rounds when every rank sends nothing.  A second
    initialize_distributed is a no-op."""
    r0, r1 = launch(tmp_path, dict(mode="units"), 2)
    conv, x, cot = torch_mp_worker.bn_case(8)
    y, x_grad, w_grad = torch_mp_worker.bn_forward_backward(conv, x, cot)
    got_y = torch.tensor(r0["y"] + r1["y"])
    got_xg = torch.tensor(r0["x_grad"] + r1["x_grad"])
    got_wg = torch.tensor(r0["w_grad"]) + torch.tensor(r1["w_grad"])
    torch.testing.assert_close(got_y, y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_xg, x_grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_wg, w_grad, rtol=1e-5, atol=1e-4)
    # the four rows alone would normalise otherwise: the check can fail
    y_local, _, _ = torch_mp_worker.bn_forward_backward(
        *torch_mp_worker.bn_case(8)[:1], x[:4], cot[:4])
    assert (y_local - y[:4]).abs().max() > 1e-2
    want = [torch_mp_worker.gather_blob(r).hex() for r in range(2)]
    for r in (r0, r1):
        assert r["gathered"] == want and r["rounds"] == 4
        assert r["empty"] == ["", ""] and r["empty_rounds"] == 0
        assert r["reinit"] is True and r["collectives"]["all_gather"] >= 6


@pytest.mark.parametrize("rank,nproc,spool", [
    (0, 1, ""), (1, 2, ""), (3, 4, ""), (2, 4, "runs/s.jsonl")])
def test_spool_name_and_stripe_match_jax(monkeypatch, tmp_path, rank, nproc,
                                         spool):
    """The spool file (.p{rank} under several processes, an explicit
    spool_path too) and the grid signature's stripe are the JAX SFinder's,
    so a spool of either package resumes in the other."""
    import jax

    from caesar_yolo_tpu.parallel.sfinder import (
        SFinder as JaxSFinder,
        SFinderConfig as JaxConfig,
    )
    from caesar_yolo_tpu_torch.parallel.sfinder import SFinder, SFinderConfig

    monkeypatch.setattr(mesh, "process_index", lambda: rank)
    monkeypatch.setattr(mesh, "process_count", lambda: nproc)
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    monkeypatch.setattr(jax, "process_count", lambda: nproc)
    kw = dict(image_path=str(tmp_path / "field.fits"), spool_path=spool,
              split_image_in_tiles=True, tile_xsize=96, tile_ysize=96)
    port = SFinder(None, SFinderConfig(**kw), device="cpu")
    ref = JaxSFinder(None, None, JaxConfig(**kw))
    assert port._spool_file() == ref._spool_file()
    if nproc > 1:
        assert port._spool_file().endswith(f".p{rank}.jsonl")
    assert port._grid_signature() == ref._grid_signature()
    assert port._grid_signature()["stripe"] == [rank, nproc]


def test_devices_and_backend_outside_and_inside_a_group(monkeypatch):
    """Without a launcher initialize_distributed is a no-op and the
    default device is CUDA; under a group it is cuda:{LOCAL_RANK}, which
    raises here (no GPU) instead of running on the CPU, while an explicit
    device is honoured.  The backend follows the device."""
    from caesar_yolo_tpu_torch.utils.device import resolve_device

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert mesh.initialize_distributed() is False
    assert not mesh.distributed()
    assert mesh.process_index() == 0 and mesh.process_count() == 1
    assert mesh.backend_for(None) == "nccl"
    assert mesh.backend_for("cuda:1") == "nccl"
    assert mesh.backend_for("cpu") == "gloo"
    monkeypatch.setattr(mesh, "distributed", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="local rank 1 has no GPU"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")
    assert mesh.pad_to_multiple(17, 4) == 20
