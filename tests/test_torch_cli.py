"""The port's detection CLI: the JAX CLI's flags and defaults, a tiled and
a serial run on the CPU writing the port SFinder's catalog and DS9 file,
the tiled run's device-tiling, statistics-context, spool, profiler and
tile-image flags taking effect, the flags that were once refused taking
effect, and CUDA by default."""

import json
import os

import numpy as np
import pytest
import torch

from caesar_yolo_tpu.cli.run import parse_args as jax_parse_args
from caesar_yolo_tpu_torch.cli.preproc_args import build_preprocessor_from_args
from caesar_yolo_tpu_torch.cli.run import main, parse_args
from caesar_yolo_tpu_torch.models.convert import load_model
from caesar_yolo_tpu_torch.parallel.sfinder import SFinder, SFinderConfig
from caesar_yolo_tpu_torch.utils.fits import write_fits

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
WEIGHTS = os.path.join(FIXTURES, "yolov8n_synth96.npz")
PREPROC_FLAGS = ["--preprocessing", "--subtract_bkg", "--chan3_preproc",
                 "-sigma_clip_baseline=0", "-sigma_clip_low=1",
                 "--sigma_clip_up=20", "--normalize_minmax", "--norm_min=0",
                 "--norm_max=1"]
TILE_FLAGS = ["--split_img_in_tiles", "--tile_xsize=96", "--tile_ysize=96",
              "--tile_xstep=0.75", "--tile_ystep=0.75", "--batch_size=4",
              "--max_ntasks_per_worker=1000"]


@pytest.mark.parametrize("argv", [
    ["--weights=w.npz"],
    ["--weights=w.npz", "--image=m.fits", *PREPROC_FLAGS, *TILE_FLAGS,
     "--scoreThr=0.25", "--imgsize=96", "--relay_bf16", "--multigpu"],
    ["--weights", "w.npz", "--zscale_stretch", "--zscale_contrasts=0.2,0.3",
     "-nchannels", "3", "-bkg_chid", "1", "--use_box_mask_in_bkg",
     "-bkg_box_mask_fract=0.5", "--clip_shift_data", "-sigma_clip=2",
     "--clip_data", "-clip_chid=0", "-sigma_bkg", "2.5", "--xmin=1",
     "--xmax=50", "--ymin=2", "--ymax=60", "--detect_outfile=a.reg",
     "--detect_outfile_json=a.json", "--save_tile_catalog",
     "--devices=cpu", "--pre_nms=1024", "--iouThr=0.4"],
    ["--weights=w.npz", "--image=m.fits", *TILE_FLAGS, "--resume",
     "--spool_path=s.jsonl", "--profile_dir=prof", "--device_tiling=on",
     "--preproc_context=global", "--save_tile_img"],
])
def test_parse_args_matches_jax(argv):
    got, ref = vars(parse_args(argv)), vars(jax_parse_args(argv))
    assert got == ref


def _mosaic(tmp_path):
    """The golden mosaic (tests/test_torch_sfinder.py) as a FITS file."""
    with np.load(os.path.join(FIXTURES,
                              "torch_port_golden_mosaic_v8n96.npz")) as f:
        mosaic = f["mosaic"]
    path = str(tmp_path / "mosaic.fits")
    write_fits(mosaic, path)
    return path


@pytest.mark.parametrize("tiled", [True, False], ids=["tiled", "serial"])
def test_main_writes_the_sfinder_catalog(tmp_path, tiled):
    """`main --devices=cpu` writes the JSON catalog and DS9 file that the
    port's SFinder writes for the same configuration."""
    path = _mosaic(tmp_path)
    out = {k: str(tmp_path / f"cli.{k}") for k in ("json", "reg")}
    argv = [f"--image={path}", f"--weights={WEIGHTS}", "--imgsize=96",
            "--scoreThr=0.3", "--devices=cpu", *PREPROC_FLAGS,
            f"--detect_outfile_json={out['json']}",
            f"--detect_outfile={out['reg']}"]
    if tiled:
        argv += TILE_FLAGS
    assert main(argv) == 0

    cfg = SFinderConfig(
        image_path=path, image_xmin=-1, image_xmax=-1, image_ymin=-1,
        image_ymax=-1, img_size=96, score_thr=0.3,
        split_image_in_tiles=tiled, tile_xsize=96, tile_ysize=96,
        tile_xstep=0.75, tile_ystep=0.75, batch_size=4,
        max_ntasks_per_worker=1000,
        outfile_json=str(tmp_path / "sf.json"),
        outfile_ds9=str(tmp_path / "sf.reg"))
    sf = SFinder(load_model(WEIGHTS)[0], cfg, device="cpu",
                 preprocessor=build_preprocessor_from_args(
                     parse_args(["--weights=w", *PREPROC_FLAGS])))
    assert (sf.run_tiled() if tiled else sf.run()) == 0
    for k in ("json", "reg"):
        got = open(out[k]).read()
        assert got == open(str(tmp_path / f"sf.{k}")).read()
    assert len(sf.sources["sources"]) >= 3
    assert open(out["reg"]).read().count("\n") == 2 + len(
        sf.sources["sources"])


def test_max_ntasks_guard(tmp_path):
    """More tiles than --max_ntasks_per_worker on the one device: the
    reference's guard refuses the run (exit code 1, no catalog)."""
    out = tmp_path / "c.json"
    assert main([f"--image={_mosaic(tmp_path)}", f"--weights={WEIGHTS}",
                 "--imgsize=96", "--devices=cpu", *TILE_FLAGS[:-1],
                 "--max_ntasks_per_worker=8",
                 f"--detect_outfile_json={out}"]) == 1
    assert not out.exists()


@pytest.mark.parametrize("flag", [
    "--datalist=list.txt", "--int8", "--draw_plots", "--save_plots", ".pt"])
def test_unported_flags_raise(tmp_path, monkeypatch, flag):
    """Each flag the port once refused now takes effect.  --datalist runs
    its list (here the mosaic, whole-image through the BatchedDetector,
    writing out_mosaic.json and .reg into the working directory), and so
    do .pt weights (the fixture's as an ultralytics checkpoint, converted
    on the fly: the npz's catalog) and --int8 (calibrated on the mosaic,
    the sources the float run finds found again, same classes).
    --draw_plots draws the catalog's boxes over the image and shows the
    figure (plt.show, recorded here); with --save_plots it writes
    out_mosaic.png instead, as the JAX package does."""
    path = _mosaic(tmp_path)
    weights = WEIGHTS
    argv = [f"--image={path}", "--devices=cpu", "--imgsize=96"]
    if flag.startswith("--datalist"):
        (tmp_path / "list.txt").write_text(path + "\n")
        monkeypatch.chdir(tmp_path)
        assert main([*argv, flag, f"--weights={weights}"]) == 0
        assert (tmp_path / "out_mosaic.json").exists()
        assert (tmp_path / "out_mosaic.reg").exists()
        return
    if flag == ".pt":
        import chip_smoke as cs
        pt = str(tmp_path / "yolov8n_synth96.pt")
        cs.save_ultralytics_pt(torch, pt,
                               cs.ultralytics_state(load_model(WEIGHTS)[0]))
        cats = []
        for w in (pt, WEIGHTS):
            out = tmp_path / f"{os.path.basename(w)}.json"
            assert main([*argv, f"--weights={w}", "--scoreThr=0.3",
                         f"--detect_outfile_json={out}",
                         f"--detect_outfile={out}.reg"]) == 0
            cats.append(json.loads(out.read_text()))
        assert cats[0] == cats[1]
        return
    if flag == "--int8":
        cats = []
        for extra in ([], [flag]):
            out = tmp_path / f"int8{len(extra)}.json"
            assert main([*argv, *PREPROC_FLAGS, *extra, "--scoreThr=0.5",
                         f"--weights={weights}", f"--detect_outfile_json={out}",
                         f"--detect_outfile={out}.reg"]) == 0
            cats.append(json.loads(out.read_text())["objs"])
        assert len(cats[0]) >= 3 and len(cats[1]) >= len(cats[0]) - 1
        assert {o["class_id"] for o in cats[1]} == {
            o["class_id"] for o in cats[0]}
        return
    plt = pytest.importorskip("matplotlib.pyplot")
    shown = []
    monkeypatch.setattr(plt, "show", lambda: shown.append(
        len(plt.gca().patches)))
    monkeypatch.chdir(tmp_path)
    flags = ["--draw_plots"] + (["--save_plots"] if flag == "--save_plots"
                                else [])
    assert main([*argv, *flags, "--scoreThr=0.3",
                 f"--weights={weights}"]) == 0
    n_objs = len(json.loads((tmp_path / "out_mosaic.json").read_text())[
        "objs"])
    assert n_objs >= 3
    png = tmp_path / "out_mosaic.png"
    if flag == "--save_plots":
        assert shown == [] and png.read_bytes()[:4] == b"\x89PNG"
    else:
        assert shown == [n_objs] and not png.exists()
        plt.close("all")


def _fake_spool(path, argv, score):
    """A spool at path under the signature of the run argv configures,
    holding one object of the given score as tile 0's result."""
    from caesar_yolo_tpu_torch.cli.run import config_from_args
    sig = SFinder(None, config_from_args(parse_args(argv)),
                  device="cpu")._grid_signature()
    obj = {"name": "S1_t0", "x1": 1.0, "x2": 5.0, "y1": 1.0, "y2": 5.0,
           "class_id": 1, "class_name": "compact", "score": score,
           "edge": 0}
    with open(path, "w") as f:
        f.write(json.dumps({"gridSig": sig}) + "\n" + json.dumps(
            {"objs": [obj], "tileId": 0, "workerId": 0,
             "neighborTileIds": [], "xmin": 0, "xmax": 96, "ymin": 0,
             "ymax": 96}) + "\n")


@pytest.mark.parametrize("flag", [
    "--resume", "--spool_path=s.jsonl", "--profile_dir=prof",
    "--preproc_context=global", "--device_tiling=on", "--save_tile_img"])
def test_tiled_flags_take_effect(tmp_path, monkeypatch, flag):
    """Each flag the port once refused runs on the CPU and does what it
    says: a spool (the default one, or the --spool_path one with
    --resume) is resumed and removed; --profile_dir leaves a trace;
    --preproc_context=global preprocesses the whole mosaic once on the
    device-resident path that "auto" takes here; --device_tiling=on ships
    the mosaic once and gives the streamed run's catalog; --save_tile_img
    writes each predicted tile's window."""
    from caesar_yolo_tpu_torch.cli.run import run
    monkeypatch.chdir(tmp_path)
    path = _mosaic(tmp_path)
    argv = [f"--image={path}", f"--weights={WEIGHTS}", "--imgsize=96",
            "--scoreThr=0.3", "--devices=cpu", *PREPROC_FLAGS, *TILE_FLAGS]
    rc, base = run([*argv, "--device_tiling=off"])
    assert rc == 0 and base.report.tiling_mode == "stream"
    with open("catalog_mosaic.json") as f:
        streamed = json.load(f)["sources"]
    extra = [flag]
    spool = None
    if flag in ("--resume", "--spool_path=s.jsonl"):
        spool = tmp_path / ("s.jsonl" if flag != "--resume"
                            else ".mosaic.tilespool.jsonl")
        extra = sorted({flag, "--resume"})
        _fake_spool(spool, [*argv, *extra], 0.99)
    rc, sf = run([*argv, *extra])
    assert rc == 0
    with open("catalog_mosaic.json") as f:
        sources = json.load(f)["sources"]
    rep = sf.report
    if spool is not None:
        assert 0.99 in {s["score"] for s in sources}
        assert rep.n_resumed == 1 and not spool.exists()
    elif flag == "--profile_dir=prof":
        events = json.loads((tmp_path / "prof" / "mosaic.trace.json")
                            .read_text())["traceEvents"]
        assert len(events) > 100
    elif flag == "--preproc_context=global":
        assert rep.tiling_mode == "full"
        assert "preprocess_mosaic" in rep.phase_times
        assert sources != streamed
    elif flag == "--device_tiling=on":
        assert rep.tiling_mode == "full"
        assert rep.h2d_bytes == 208 * 208 * 4 < base.report.h2d_bytes
        assert sources == streamed
    else:
        names = sorted(p.name for p in tmp_path.glob("timg_*.fits"))
        assert names == sorted(f"timg_mosaic_tid{tr['tileId']}.fits"
                               for tr in sf.last_tile_results)
        assert len(names) == 8


def test_main_needs_cuda_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device is usable")
    path = _mosaic(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        main([f"--image={path}", f"--weights={WEIGHTS}", "--imgsize=96"])
    assert main([f"--image={path}", f"--weights={WEIGHTS}", "--imgsize=96",
                 "--devices=cpu", "--scoreThr=0.3",
                 f"--detect_outfile_json={tmp_path / 'o.json'}",
                 f"--detect_outfile={tmp_path / 'o.reg'}"]) == 0
    assert json.loads((tmp_path / "o.json").read_text())["objs"]
