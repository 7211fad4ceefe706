"""Checkpoint conversion CLI.

    python -m caesar_yolo_tpu_torch.cli.convert weights.pt [out.npz]
        [--model yolov8l] [--num_classes N]

Counterpart of caesar_yolo_tpu/cli/convert.py: the same arguments and
exit codes.  Reads an ultralytics `.pt` checkpoint without the ultralytics
package (models/convert.py: the ghost-module unpickler; the class count
from the head) and writes the reference's npz format, which both packages'
`load_params` read.  `cli.run --weights=w.pt` and `cli.evaluate` convert
on the fly; this command keeps the result.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("weights", help="ultralytics .pt checkpoint")
    ap.add_argument("out", nargs="?", default=None,
                    help="output .npz (default: <weights-stem>.npz)")
    ap.add_argument("--model", default=None,
                    help="architecture name (default: weights filename "
                         "stem, e.g. yolov8l)")
    ap.add_argument("--num_classes", type=int, default=None,
                    help="class count (default: inferred from the head)")
    args = ap.parse_args(argv)

    from caesar_yolo_tpu_torch import logger
    from caesar_yolo_tpu_torch.models.convert import convert_checkpoint

    out = args.out or os.path.splitext(args.weights)[0] + ".npz"
    try:
        convert_checkpoint(args.weights, out_path=out,
                           model_name=args.model,
                           num_classes=args.num_classes)
    except Exception as e:  # CLI boundary: a missing or corrupt file, a
        # bad key or name exits 1 with the error logged, not a traceback
        logger.error("Conversion failed: %s", e)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
