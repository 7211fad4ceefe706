#!/usr/bin/env python3
"""K9 (the int8 conv, csrc/qconv.cu) at yolo11l's int8 conv shapes.

For each shape, chip_smoke.qconv_timing's row at batch 32 in bf16: the
whole call by CUDA events and its device time split into the quantize
pass and the GEMM, each part timed alone, the plain version, the bound,
torch._int_mm on the unfolded int8 input and cuDNN's bf16 conv of the
shape.  Prints the card's name and power limit first.

Run from the repository root on a CUDA card:
    python3 scripts/torch_qconv_timing.py
"""

from __future__ import annotations

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# (cin, cout, h, w, k, stride): the most launched 3x3 conv at 640 px, the
# 3x3 convs at 80 and 160 px with 64 and 32 channels, and a 1x1 conv
SHAPES = ((128, 128, 40, 40, 3, 1), (64, 64, 80, 80, 3, 1),
          (32, 32, 160, 160, 3, 1), (256, 256, 40, 40, 1, 1))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    import chip_smoke as cs
    from caesar_yolo_tpu_torch.models import cuda_qconv
    cs.CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(cs.CARD, flush=True)
    for key in SHAPES:
        cs.qconv_timing(torch, cuda_qconv, key, 0.0, "a yolo11l conv")
    return 0


if __name__ == "__main__":
    sys.exit(main())
