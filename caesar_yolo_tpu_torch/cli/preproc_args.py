"""Shared preprocessing CLI flags and builder.

A copy of caesar_yolo_tpu/cli/preproc_args.py: the reference's
preprocessing flag set (reference scripts/run.py:58-155), with the same
defaults and single-dash spellings, and the flag->Pipeline assembly
(reference scripts/run.py:272-302) onto the port's build_preprocessor.
"""

from __future__ import annotations


def add_preprocessing_args(parser) -> None:
    """Register the full preprocessing flag set (run.py defaults).

    Eleven flags also take the reference's single-dash spelling
    (``-sigma_clip_low`` etc. — reference scripts/run.py declares them
    as ``('-name', '--name')`` pairs), so migrated invocations parse
    unchanged."""
    parser.add_argument("--preprocessing", action="store_true")
    parser.add_argument("--normalize_minmax", action="store_true")
    parser.add_argument("-norm_min", "--norm_min", type=float, default=0.0)
    parser.add_argument("-norm_max", "--norm_max", type=float, default=1.0)
    parser.add_argument("--subtract_bkg", action="store_true")
    parser.add_argument("-sigma_bkg", "--sigma_bkg", type=float, default=3.0)
    parser.add_argument("--use_box_mask_in_bkg", action="store_true")
    parser.add_argument("-bkg_box_mask_fract", "--bkg_box_mask_fract",
                        type=float, default=0.7)
    parser.add_argument("-bkg_chid", "--bkg_chid", type=int, default=-1)
    parser.add_argument("--clip_shift_data", action="store_true")
    parser.add_argument("-sigma_clip", "--sigma_clip", type=float,
                        default=1.0)
    parser.add_argument("--clip_data", action="store_true")
    parser.add_argument("-sigma_clip_low", "--sigma_clip_low", type=float,
                        default=10.0)
    parser.add_argument("-sigma_clip_up", "--sigma_clip_up", type=float,
                        default=10.0)
    parser.add_argument("-clip_chid", "--clip_chid", type=int, default=-1)
    parser.add_argument("--zscale_stretch", action="store_true")
    parser.add_argument("--zscale_contrasts", type=str,
                        default="0.25,0.25,0.25")
    parser.add_argument("--chan3_preproc", action="store_true")
    parser.add_argument("-sigma_clip_baseline", "--sigma_clip_baseline",
                        type=float, default=0.0)
    parser.add_argument("-nchannels", "--nchannels", type=int, default=1)


def build_preprocessor_from_args(args):
    """Assemble the Pipeline exactly as the reference CLI does
    (reference scripts/run.py:272-302)."""
    from caesar_yolo_tpu_torch.ops.transforms import build_preprocessor
    if not args.preprocessing:
        return None
    contrasts = [float(v) for v in args.zscale_contrasts.split(",")]
    return build_preprocessor(
        subtract_bkg=args.subtract_bkg, sigma_bkg=args.sigma_bkg,
        use_box_mask_in_bkg=args.use_box_mask_in_bkg,
        bkg_box_mask_fract=args.bkg_box_mask_fract, bkg_chid=args.bkg_chid,
        clip_shift_data=args.clip_shift_data, sigma_clip=args.sigma_clip,
        clip_data=args.clip_data, sigma_clip_low=args.sigma_clip_low,
        sigma_clip_up=args.sigma_clip_up, clip_chid=args.clip_chid,
        nchannels=args.nchannels, zscale_stretch=args.zscale_stretch,
        zscale_contrasts=contrasts, chan3_preproc=args.chan3_preproc,
        sigma_clip_baseline=args.sigma_clip_baseline,
        normalize_minmax=args.normalize_minmax, norm_min=args.norm_min,
        norm_max=args.norm_max)
