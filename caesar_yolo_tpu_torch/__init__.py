"""caesar-yolo-tpu ported to PyTorch and CUDA for NVIDIA Hopper (H100).

A second package beside `caesar_yolo_tpu` (the JAX reference, which it
never imports).  Plain tensor code is PyTorch; each TPU kernel of the
reference on the ported path is a kernel written by hand for Hopper in
`csrc/`, built with nvcc at first use (`cuda_build`).

Package layout (bottom-up), named after the reference's modules:
  utils/     FITS I/O, tiling, box math, union-find, synthetic mosaics,
             device selection
  ops/       zscale, sigma-clipped statistics (kernel K5), histogram
             equalisation (kernel K6), the preprocessing stages and the
             README chain (kernel K3), 2x upsample (kernel K4), the
             augmentation's row shift (kernel K8)
  models/    YOLOv8 / YOLO11 as nn.Modules (inference and train mode),
             attention and its gradient (kernel K2), npz weights to and
             from the reference's format
  detect/    letterbox, fixed-shape NMS (kernel K1), predictor, merge,
             analyzer
  parallel/  the batched tile engine and the mosaic source finder, edge
             flags and stitch, and the process-group helpers of multi-GPU
             runs (one process per GPU, torch.distributed)
  outputs/   JSON catalog and DS9 region writers
  train/     detection loss and assigner, augmentation, dataset, trainer
  cli/       the detection and training command lines (`python -m
             caesar_yolo_tpu_torch.cli.run`, `... .cli.train`)

Entry points run on CUDA (under a process group, cuda:{LOCAL_RANK})
unless the caller passes device="cpu" (the CLI: --devices=cpu).
"""

import logging
import sys

__version__ = "0.1.0"

logger = logging.getLogger("caesar_yolo_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stdout)
    _h.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)
    logger.propagate = False
