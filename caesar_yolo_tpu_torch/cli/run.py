"""Command-line detection entry point.

Flag-compatible with caesar_yolo_tpu/cli/run.py (and so with the
reference CLI, reference scripts/run.py:58-155): the same flags,
defaults and single-dash spellings.

    python -m caesar_yolo_tpu_torch.cli.run --image=mosaic.fits \
        --weights=w.npz --preprocessing --subtract_bkg --chan3_preproc \
        --normalize_minmax [--split_img_in_tiles --tile_xsize=512 ...]

Runs on CUDA; `--devices` names another device (`cpu` for the CPU).  On
several GPUs, one process each:

    torchrun --nproc_per_node=4 -m caesar_yolo_tpu_torch.cli.run \
        --image=mosaic.fits --weights=w.npz --split_img_in_tiles ...

Each rank runs on cuda:{LOCAL_RANK} unless --devices names its device
(ranks on one GPU, or on the CPU, talk over gloo).  Tiled runs, also of a
--datalist, stripe the tiles over the ranks and gather their results on
every rank (parallel/sfinder.py); serial and batched runs do the whole
work on every rank, as the JAX package's do.  Only rank 0 writes the
catalogs and regions.  `--weights` takes the
reference's npz format or an ultralytics `.pt` checkpoint, converted on
the fly (models/convert.py).  `--image` and `--datalist` take FITS, PNG
and JPEG images (JPEG needs Pillow; utils/fits.py:read_image); tiled runs
take FITS only, as the reference's do.  `--datalist` runs a filelist
as the reference package does: tiled through one shared TileEngine with
--split_img_in_tiles, per image through the SFinder when outfiles or a
crop window are given, else batched by shape through the BatchedDetector
(out_<stem>.json and .reg per image).  Tiled runs take the reference's
device-tiling modes (--device_tiling auto/on/off: the mosaic or its bands
shipped to the device once), --preproc_context=global, the crash-resume
spool (--resume, --spool_path), --profile_dir (a torch.profiler Chrome
trace) and --save_tile_img.  --int8 quantizes the dense convs (int8 PTQ,
models/quant.py) after calibrating on up to three crops of the input image
(with --datalist, of its first image); on the card their convs run on
kernel K9.  --draw_plots draws the detections over the image of a serial
run (with --save_plots into out_<image>.png, else shown; matplotlib,
imported only then); with --datalist it takes the per-image path.
--multigpu is a no-op, as in the reference package.

npz weights (but with --int8, whose calibration runs the f32 model) go
to the device in one pass: read once into one host buffer, copied over
in one piece, folded and cast there (models/convert.py: read_npz,
build_prepared), and the engine runs that model itself
(predictor.prepare_model).  A `.pt` checkpoint, --int8, and an npz that
read_npz leaves to np.load (compressed, int8, fused) take the f32 model
on the CPU (load_model_from_args), which the engine copies, folds and
casts.

A single image's run records the spans `cli.load_weights` (child
`weights.read` on the npz route), `cli.build` (children `weights.upload`
and `weights.fold` on the npz route) and `cli.preprocessor` into the
recorder it hands the SFinder, so a tiled run's SFinderReport.phase_times
holds them beside the SFinder's own (utils/trace.py).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from dataclasses import replace

from caesar_yolo_tpu_torch import logger
from caesar_yolo_tpu_torch.cli.preproc_args import (
    add_preprocessing_args,
    build_preprocessor_from_args,
)
from caesar_yolo_tpu_torch.evaluation.evaluate import read_filelist
from caesar_yolo_tpu_torch.utils.trace import NULL, Recorder


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="caesar-yolo-tpu (PyTorch port) options")

    # DATA
    parser.add_argument("--image", required=False, type=str, default="",
                        help="Input image (FITS, PNG or JPEG) to detect "
                        "on")
    parser.add_argument("--datalist", required=False, default="",
                        help="Filelist of images for batch detection")
    parser.add_argument("--maxnimgs", required=False, type=int, default=-1)

    # MODEL
    parser.add_argument("--weights", required=True,
                        help="Weights: the reference's npz format or an "
                        "ultralytics .pt checkpoint")
    parser.add_argument("--model", required=False, default="",
                        help="Architecture name (default: from the weights' "
                        "meta, else their file name)")

    # PREPROCESSING (shared flag set: cli/preproc_args.py)
    parser.add_argument("--imgsize", type=int, default=640)
    add_preprocessing_args(parser)

    # DETECT
    parser.add_argument("--scoreThr", type=float, default=0.7)
    parser.add_argument("--iouThr", type=float, default=0.5)
    parser.add_argument("--pre_nms", type=int, default=512,
                        help="Pre-NMS candidate window (above-threshold "
                        "candidates beyond it are dropped WITH a log; "
                        "raise for crowded fields)")
    parser.add_argument("--resume", action="store_true",
                        help="Resume a crashed tiled run from its spool")
    parser.add_argument("--spool_path", type=str, default="",
                        help="Tile-result spool file (default "
                        ".<image>.tilespool.jsonl in the working directory)")
    parser.add_argument("--profile_dir", type=str, default="",
                        help="Write a torch.profiler trace of the tiled run "
                        "into this directory")
    parser.add_argument("--device_tiling", choices=["auto", "on", "off"],
                        default="auto",
                        help="Ship the mosaic (or its bands) to the device "
                        "once and cut tiles there: auto when it ships fewer "
                        "bytes than windowed reads; on: always; off: never")
    parser.add_argument("--preproc_context", choices=["tile", "global"],
                        default="tile",
                        help="Statistics context of tiled-run "
                        "preprocessing: per tile (reference parity) or the "
                        "whole mosaic (needs the full device-resident path)")
    parser.add_argument("--relay_bf16", action="store_true",
                        help="Ship tiles to the device as bfloat16 (half "
                        "the host->device bytes; ~0.4%% pixel rounding)")
    parser.add_argument("--int8", action="store_true",
                        help="int8 PTQ inference: quantize dense convs "
                        "after calibrating activation ranges on samples "
                        "from the input image (models/quant.py)")
    parser.add_argument("--merge_overlap_iou_thr_soft", type=float,
                        default=0.3)
    parser.add_argument("--merge_overlap_iou_thr_hard", type=float,
                        default=0.8)
    parser.add_argument("--xmin", type=int, default=-1)
    parser.add_argument("--xmax", type=int, default=-1)
    parser.add_argument("--ymin", type=int, default=-1)
    parser.add_argument("--ymax", type=int, default=-1)

    # TILING / PARALLEL
    parser.add_argument("--split_img_in_tiles", action="store_true")
    parser.add_argument("--tile_xsize", type=int, default=512)
    parser.add_argument("--tile_ysize", type=int, default=512)
    parser.add_argument("--tile_xstep", type=float, default=1.0)
    parser.add_argument("--tile_ystep", type=float, default=1.0)
    parser.add_argument("--max_ntasks_per_worker", type=int, default=100)
    parser.add_argument("--batch_size", type=int, default=128,
                        help="tiles per device batch (small mosaics pad "
                        "up to it)")

    # RUN
    parser.add_argument("--devices", type=str, default="",
                        help="torch device (default cuda, under torchrun "
                        "cuda:LOCAL_RANK; cpu runs on the CPU)")
    parser.add_argument("--multigpu", action="store_true",
                        help="(compat no-op)")

    # DRAW / SAVE
    parser.add_argument("--draw_plots", action="store_true")
    parser.add_argument("--draw_class_label_in_caption", action="store_true")
    parser.add_argument("--save_plots", action="store_true")
    parser.add_argument("--save_tile_catalog", action="store_true")
    parser.add_argument("--save_tile_region", action="store_true")
    parser.add_argument("--save_tile_img", action="store_true")
    parser.add_argument("--detect_outfile", type=str, default="")
    parser.add_argument("--detect_outfile_json", type=str, default="")

    return parser.parse_args(argv)


def validate_args(args) -> int:
    """Reference validation rules (scripts/run.py:158-190)."""
    if args.datalist:
        if not os.path.isfile(args.datalist):
            logger.error("Datalist %s not existing!", args.datalist)
            return -1
        if not args.weights or not os.path.isfile(args.weights):
            logger.error("Given weight file %s not existing or not a file!",
                         args.weights)
            return -1
        return 0
    if not args.image:
        logger.error("Argument --image is required for detect task!")
        return -1
    if not os.path.isfile(args.image):
        logger.error("Image argument must be an existing image on "
                     "filesystem!")
        return -1
    if not args.image.endswith((".fits", ".png", ".jpg")):
        logger.error("Image must have .fits/.png/.jpg extension!")
        return -1
    if args.maxnimgs == 0 or (args.maxnimgs < 0 and args.maxnimgs != -1):
        logger.error("Invalid maxnimgs given (hint: give -1 or >0)!")
        return -1
    if not args.weights or not os.path.isfile(args.weights):
        logger.error("Given weight file %s not existing or not a file!",
                     args.weights)
        return -1
    return 0


def _npz_model(args, meta: dict) -> tuple[str, int]:
    """(architecture, classes) of npz weights: from their meta, else
    --model, else the weights' file name; 5 classes."""
    name = args.model or os.path.splitext(os.path.basename(args.weights))[0]
    return meta.get("model", name), int(meta.get("num_classes", 5))


def load_model_from_args(args, recorder: Recorder = NULL):
    """The model with the weights loaded, on the CPU in f32.  A `.pt`
    checkpoint is converted on the fly (the architecture from --model,
    else the file's stem); an npz names its architecture in its meta (else
    --model, else the weights' file name).  Spans `cli.load_weights` and
    `cli.build` go to `recorder`."""
    from caesar_yolo_tpu_torch.models.convert import (
        convert_checkpoint,
        load_jax_params,
        load_params,
    )
    from caesar_yolo_tpu_torch.models.yolo import build_model
    if args.weights.endswith(".pt"):
        with recorder.span("cli.load_weights"):
            return convert_checkpoint(args.weights,
                                      model_name=args.model or None)[0]
    with recorder.span("cli.load_weights"):
        params, meta = load_params(args.weights)
    with recorder.span("cli.build"):
        name, nc = _npz_model(args, meta)
        return load_jax_params(build_model(name, num_classes=nc), params)


def load_prepared_from_args(args, device, recorder: Recorder = NULL):
    """The engine's inference model straight from npz weights: read once
    into one host buffer (pinned for a GPU), copied to `device` in one
    piece, folded and cast there (models/convert.py: read_npz,
    build_prepared), in the engines' compute dtype (predictor.
    COMPUTE_DTYPE).  None where the weights take load_model_from_args'
    route: a `.pt` checkpoint, or an npz read_npz leaves to np.load.
    Spans `cli.load_weights` (child `weights.read`) and `cli.build`
    (children `weights.upload`, `weights.fold`) go to `recorder`."""
    from caesar_yolo_tpu_torch.detect import predictor
    from caesar_yolo_tpu_torch.models.convert import build_prepared, read_npz
    if args.weights.endswith(".pt"):
        return None
    with recorder.span("cli.load_weights"):
        weights = read_npz(args.weights, pin=device.type == "cuda",
                           recorder=recorder)
    if weights is None:
        return None
    with recorder.span("cli.build"):
        name, nc = _npz_model(args, weights.meta)
        return build_prepared(weights, name, nc,
                              dtype=predictor.COMPUTE_DTYPE, device=device,
                              recorder=recorder)


def quantize_from_image(model, image_path, preproc, img_size, device=None):
    """int8 PTQ for the CLI (the reference's cli/run.py:182-207):
    calibrate the activation ranges on up to three square crops of side
    min(h, w, 640) of the input image itself (its corners (0, 0) and
    (h - s, w - s) and its centre), prepared as the engine prepares
    tiles, then quantize.  Returns the int8 model."""
    import numpy as np

    from caesar_yolo_tpu_torch.evaluation.evaluate import load_eval_image
    from caesar_yolo_tpu_torch.models.quant import (
        calibration_inputs_from_tiles,
        quantize_model,
    )

    a = load_eval_image(image_path) if image_path else None
    if a is None:
        raise ValueError(f"cannot read calibration image {image_path}")
    if a.ndim == 2:
        a = a[..., None]
    h, w = a.shape[:2]
    s = min(h, w, 640)
    corners = {(0, 0), (h - s, w - s), ((h - s) // 2, (w - s) // 2)}
    tiles = np.stack([a[cy:cy + s, cx:cx + s] for cy, cx in sorted(corners)])
    calib = calibration_inputs_from_tiles(
        tiles, preprocessor=preproc, img_size=img_size,
        nchan=model.in_channels, device=device)
    logger.info("int8 PTQ: calibrated on %d %dpx crops of %s",
                len(tiles), s, image_path)
    return quantize_model(model, calib)


def config_from_args(args):
    from caesar_yolo_tpu_torch.parallel.sfinder import SFinderConfig
    return SFinderConfig(
        image_path=args.image,
        image_xmin=args.xmin, image_xmax=args.xmax,
        image_ymin=args.ymin, image_ymax=args.ymax,
        img_size=args.imgsize, score_thr=args.scoreThr,
        iou_thr=args.iouThr, pre_nms=args.pre_nms,
        relay_dtype="bfloat16" if args.relay_bf16 else "float32",
        device_tiling=args.device_tiling,
        preproc_context=args.preproc_context,
        resume=args.resume, spool_path=args.spool_path,
        profile_dir=args.profile_dir,
        merge_overlap_iou_thr_soft=args.merge_overlap_iou_thr_soft,
        merge_overlap_iou_thr_hard=args.merge_overlap_iou_thr_hard,
        split_image_in_tiles=args.split_img_in_tiles,
        tile_xsize=args.tile_xsize, tile_ysize=args.tile_ysize,
        tile_xstep=args.tile_xstep, tile_ystep=args.tile_ystep,
        max_ntasks_per_worker=args.max_ntasks_per_worker,
        batch_size=args.batch_size,
        save_tile_catalog=args.save_tile_catalog,
        save_tile_region=args.save_tile_region,
        save_tile_img=args.save_tile_img,
        draw_plot=args.draw_plots, save_plot=args.save_plots,
        draw_class_label_in_caption=args.draw_class_label_in_caption,
        outfile_json=args.detect_outfile_json,
        outfile_ds9=args.detect_outfile)


def _per_image_path(template: str, path: str, n_images: int) -> str:
    """A fixed per-run file (outfiles, spool) gets the image stem appended
    for a datalist of more than one image: a shared path would keep only
    the last image's output (and a shared spool would lose every other
    image's resume state)."""
    if not template or n_images == 1:
        return template
    stem = os.path.splitext(os.path.basename(path))[0]
    base, ext = os.path.splitext(template)
    return f"{base}_{stem}{ext}"


def _per_image_config(cfg, path: str, n: int):
    return replace(cfg, image_path=path,
                   outfile_json=_per_image_path(cfg.outfile_json, path, n),
                   outfile_ds9=_per_image_path(cfg.outfile_ds9, path, n),
                   spool_path=_per_image_path(cfg.spool_path, path, n))


def run_datalist_tiled(model, cfg, images, preproc, device=None) -> int:
    """Tiled detection over a datalist, every image through ONE shared
    TileEngine."""
    from caesar_yolo_tpu_torch.parallel.sfinder import SFinder

    status, engine = 0, None
    for path in images:
        sf = SFinder(model, _per_image_config(cfg, path, len(images)),
                     preprocessor=preproc, engine=engine, device=device)
        rc = sf.run_tiled()
        engine = sf._engine
        if rc != 0:
            logger.error("Detection failed on %s, continuing", path)
            status = 1
    return status


def run_datalist_serial(model, cfg, images, preproc, device=None) -> int:
    """Per-image SFinder runs (plots, outfile overrides, crop windows)
    sharing ONE Predictor."""
    from caesar_yolo_tpu_torch.parallel.sfinder import SFinder

    status, predictor = 0, None
    for path in images:
        sf = SFinder(model, _per_image_config(cfg, path, len(images)),
                     preprocessor=preproc, predictor=predictor,
                     device=device)
        rc = sf.run()
        predictor = sf._predictor
        if rc != 0:
            logger.error("Detection failed on %s, continuing", path)
            status = 1
    return status


def run_datalist_batched(model, cfg, images, preproc, device=None) -> int:
    """Whole-image detection over a datalist, batched by shape through the
    BatchedDetector; writes out_<stem>.json and out_<stem>.reg per image into
    the working directory (the reference dispatches the model once per
    image, macros/make_prediction.py:645-658)."""
    from caesar_yolo_tpu_torch.detect.batch import BatchedDetector
    from caesar_yolo_tpu_torch.detect.merge import merge_detections
    from caesar_yolo_tpu_torch.evaluation.evaluate import detect_files
    from caesar_yolo_tpu_torch.outputs.catalog import (
        make_json_results,
        make_objects,
        write_json,
    )
    from caesar_yolo_tpu_torch.outputs.ds9 import write_ds9_regions
    from caesar_yolo_tpu_torch.parallel import mesh

    t0 = time.time()
    master = mesh.process_index() == 0     # rank 0 writes
    detector = BatchedDetector(
        model, preprocessor=preproc, img_size=cfg.img_size,
        score_thr=cfg.score_thr, iou_thr=cfg.iou_thr, pre_nms=cfg.pre_nms,
        batch_size=cfg.batch_size, relay_dtype=cfg.relay_dtype,
        device=device)
    detections, shapes = detect_files(detector, images)
    status, n_total = 0, 0
    for path in images:
        det = detections.get(path)
        image_id = os.path.splitext(os.path.basename(path))[0]
        if det is None:
            logger.error("Detection failed on %s, continuing", path)
            status = 1
            continue
        boxes, scores, cls, ok = det
        if not ok:
            # as the per-image path: no outputs, nonzero exit
            logger.warning("Image %s degenerate, no prediction", path)
            status = 1
            continue
        boxes, scores, cls = merge_detections(
            boxes, scores, cls, soft_thr=cfg.merge_overlap_iou_thr_soft,
            hard_thr=cfg.merge_overlap_iou_thr_hard)
        objs = make_objects(boxes, scores, cls, image_shape=shapes[path],
                            class_names=cfg.class_names)
        n_total += len(objs)
        if cfg.save_catalog and master:
            write_json(make_json_results(image_id, objs),
                       f"out_{image_id}.json")
        if cfg.save_region and master:
            write_ds9_regions(objs, f"out_{image_id}.reg")
    logger.info("Datalist done: %d images, %d objects (%.2fs)",
                len(images), n_total, time.time() - t0)
    return status


def run(argv=None):
    """Parse, check and run -> (exit code, the SFinder after its run, or
    None for a datalist or when the arguments were rejected)."""
    args = parse_args(argv)
    if validate_args(args) < 0:
        return 1, None

    from caesar_yolo_tpu_torch.parallel import mesh
    from caesar_yolo_tpu_torch.parallel.sfinder import SFinder
    from caesar_yolo_tpu_torch.utils.device import resolve_device

    mesh.initialize_distributed(device=args.devices or None)
    # a datalist's SFinders record their own runs: the CLI's spans are
    # reported by a single image's run
    recorder = NULL if args.datalist else Recorder()
    device = resolve_device(args.devices or None)
    # --int8 calibrates the f32 model
    model = (None if args.int8
             else load_prepared_from_args(args, device, recorder))
    if model is None:
        model = load_model_from_args(args, recorder)
    cfg = config_from_args(args)
    with recorder.span("cli.preprocessor"):
        preproc = build_preprocessor_from_args(args)
    images = read_filelist(args.datalist) if args.datalist else []
    if args.int8:
        calib_image = ((images[0] if images else "") if args.datalist
                       else args.image)
        model = quantize_from_image(model, calib_image, preproc,
                                    args.imgsize, device)
    if args.datalist:
        if args.maxnimgs > 0:
            images = images[:args.maxnimgs]
        if args.split_img_in_tiles:
            route = run_datalist_tiled
        elif (args.draw_plots or args.save_plots
              or args.detect_outfile or args.detect_outfile_json
              or (args.xmin >= 0 and args.xmax > 0 and args.ymin >= 0
                  and args.ymax > 0)):
            route = run_datalist_serial
        else:
            route = run_datalist_batched
        return route(model, cfg, images, preproc, device), None
    sf = SFinder(model, cfg, preprocessor=preproc, device=device,
                 recorder=recorder)
    rc = sf.run_tiled() if args.split_img_in_tiles else sf.run()
    return (0 if rc == 0 else 1), sf


def main(argv=None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    sys.exit(main())
