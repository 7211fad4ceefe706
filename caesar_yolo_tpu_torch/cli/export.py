"""Serving-artifact export entry point.

    python -m caesar_yolo_tpu_torch.cli.export --weights=W.npz \\
        --out=detector.cyx --batch=32 --tile_xsize=640 --tile_ysize=640 \\
        [--imgsize=640 --scoreThr=0.25 --iouThr=0.5] [preproc flags...] \\
        [--platforms=cpu] [--int8 --calib_image=mosaic.fits]

Counterpart of caesar_yolo_tpu/cli/export.py, with its flags: the whole
detect step (preprocess -> letterbox -> forward -> decode -> NMS) with the
weights held in it, as one torch.export artifact (deploy.py), which
`deploy.load_detector` and `cli.serve` load without the model code.
`--weights` takes the reference's npz or an ultralytics `.pt`.
`--platforms` is "cuda" (the default) or "cpu": an artifact holds one
device's program and weights.  `--int8` exports the int8 PTQ model (the
dense convs on kernel K9 on the card), calibrated as `cli.run --int8`
calibrates, on crops of `--calib_image`.
"""

from __future__ import annotations

import argparse
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="caesar-yolo-tpu serving export (PyTorch port)")
    p.add_argument("--weights", required=True)
    p.add_argument("--model", default="")
    p.add_argument("--out", required=True, help="output artifact path")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--tile_xsize", type=int, default=640)
    p.add_argument("--tile_ysize", type=int, default=640)
    # (--nchannels comes from the shared preprocessing flag set and
    # also sets the input tile channel count)
    p.add_argument("--imgsize", type=int, default=640)
    p.add_argument("--scoreThr", type=float, default=0.25)
    p.add_argument("--iouThr", type=float, default=0.5)
    p.add_argument("--max_det", type=int, default=300)
    p.add_argument("--pre_nms", type=int, default=512)
    p.add_argument("--platforms", default="",
                   help="the artifact's device: cuda (default) or cpu")
    p.add_argument("--int8", action="store_true",
                   help="export the int8 PTQ model, calibrated on crops of "
                        "--calib_image (models/quant.py)")
    p.add_argument("--calib_image", default="",
                   help="image whose crops calibrate --int8")
    from caesar_yolo_tpu_torch.cli.preproc_args import add_preprocessing_args
    add_preprocessing_args(p)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from caesar_yolo_tpu_torch import logger
    from caesar_yolo_tpu_torch.cli.preproc_args import (
        build_preprocessor_from_args,
    )
    from caesar_yolo_tpu_torch.cli.run import (
        load_model_from_args,
        quantize_from_image,
    )
    from caesar_yolo_tpu_torch.deploy import export_detector, platform_of

    platforms = tuple(s for s in args.platforms.split(",") if s) or None
    device = platform_of(platforms)
    model = load_model_from_args(args)
    preproc = build_preprocessor_from_args(args)
    if args.int8:
        if not args.calib_image:
            logger.error("--int8 needs --calib_image to calibrate on")
            return 1
        model = quantize_from_image(model, args.calib_image, preproc,
                                    args.imgsize, device)
    blob = export_detector(
        model, preprocessor=preproc,
        tile_shape=(args.tile_ysize, args.tile_xsize, args.nchannels),
        batch=args.batch, img_size=args.imgsize, score_thr=args.scoreThr,
        iou_thr=args.iouThr, max_det=args.max_det, pre_nms=args.pre_nms,
        platforms=device)
    with open(args.out, "wb") as f:
        f.write(blob)
    logger.info("Exported %d-tile %dx%d detector to %s (%.1f MB)",
                args.batch, args.tile_ysize, args.tile_xsize, args.out,
                len(blob) / 1e6)
    return 0


if __name__ == "__main__":
    sys.exit(main())
