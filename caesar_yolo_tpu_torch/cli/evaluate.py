"""Dataset evaluation entry point (the reference's make_prediction macro).

Counterpart of caesar_yolo_tpu/cli/evaluate.py with its flags and
defaults, plus --devices:

    python -m caesar_yolo_tpu_torch.cli.evaluate --weights=W.npz \\
        --filelist=imgs.txt [--label_dir=labels/] [preproc flags...]

Computes completeness / reliability / F1 with the reference's IoU >= 0.6
matching rules (reference macros/make_prediction.py:553-694) and the
COCO-style mAP.  `--weights` takes the reference's npz or an ultralytics
`.pt` checkpoint; the filelist FITS, PNG and JPEG images.  Runs on CUDA;
`--devices=cpu` selects the CPU.  --int8 quantizes the dense convs (int8
PTQ) after calibrating on the first filelist image.  --save_plot writes
the per-class C/R/F1 figure and the precision-recall curves beside it
(matplotlib, imported only then).
"""

from __future__ import annotations

import argparse
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="caesar-yolo-tpu evaluation (PyTorch port)")
    p.add_argument("--weights", required=True)
    p.add_argument("--model", default="")
    p.add_argument("--filelist", required=True,
                   help="text file with one image path per line")
    p.add_argument("--label_dir", default="",
                   help="directory of YOLO-format label txts (default: "
                        "sibling labels/ dirs)")
    p.add_argument("--imgsize", type=int, default=640)
    p.add_argument("--scoreThr", type=float, default=0.25)
    p.add_argument("--iouThr_nms", type=float, default=0.5)
    p.add_argument("--iouThr_match", type=float, default=0.6)
    p.add_argument("--merge_overlap_iou_thr_soft", type=float, default=0.3)
    p.add_argument("--merge_overlap_iou_thr_hard", type=float, default=0.8)
    p.add_argument("--maxnimgs", type=int, default=-1)
    p.add_argument("--pre_nms", type=int, default=512)
    p.add_argument("--int8", action="store_true",
                   help="int8 PTQ inference calibrated on the first "
                        "filelist image (models/quant.py)")
    p.add_argument("--batch_size", type=int, default=32,
                   help="images per device batch")
    p.add_argument("--save_detail", default="",
                   help="write per-image match detail JSON here")
    p.add_argument("--save_plot", default="",
                   help="per-class C/R/F1 bar figure (and PR curves "
                        "beside it)")
    p.add_argument("--devices", type=str, default="",
                   help="torch device (default cuda; cpu runs on the CPU)")
    from caesar_yolo_tpu_torch.cli.preproc_args import add_preprocessing_args
    add_preprocessing_args(p)
    return p.parse_args(argv)


def run(argv=None):
    """Parse and evaluate -> (exit code, the MetricsReport)."""
    args = parse_args(argv)
    from caesar_yolo_tpu_torch.cli.preproc_args import (
        build_preprocessor_from_args,
    )
    from caesar_yolo_tpu_torch.cli.run import (
        load_model_from_args,
        quantize_from_image,
    )
    from caesar_yolo_tpu_torch.evaluation import evaluate_dataset
    from caesar_yolo_tpu_torch.evaluation.evaluate import read_filelist

    model = load_model_from_args(args)
    preproc = build_preprocessor_from_args(args)
    device = args.devices or None
    if args.int8:
        first = read_filelist(args.filelist)
        model = quantize_from_image(model, first[0] if first else "",
                                    preproc, args.imgsize, device)
    report = evaluate_dataset(
        model, args.filelist,
        label_dir=args.label_dir or None,
        preprocessor=preproc,
        img_size=args.imgsize, score_thr=args.scoreThr,
        nms_iou_thr=args.iouThr_nms, pre_nms=args.pre_nms,
        batch_size=args.batch_size,
        soft_merge_thr=args.merge_overlap_iou_thr_soft,
        hard_merge_thr=args.merge_overlap_iou_thr_hard,
        iou_thr=args.iouThr_match, max_images=args.maxnimgs,
        detail_out=args.save_detail, plot_out=args.save_plot, device=device)
    print(report.summary())
    return 0, report


def main(argv=None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    sys.exit(main())
