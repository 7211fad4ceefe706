"""The FLOP and byte counts against a hand count."""

import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from counts import model as counts
from reference.model import Conv, Conv2dRaw


def test_flop_counter_counts_a_conv_stack_as_by_hand():
    stack = nn.Sequential(Conv(3, 8, 3, 2), Conv(8, 16, 1), Conv2dRaw(16, 4))
    x = torch.zeros(2, 3, 32, 32, device="meta")
    with FlopCounterMode(display=False) as fc:
        stack.to("meta").eval()(x)
    # 2 flops a multiply-add: outputs x fan-in
    hand = 2 * (2 * 8 * 16 * 16 * 3 * 9 + 2 * 16 * 16 * 16 * 8
                + 2 * 4 * 16 * 16 * 16)
    assert fc.get_total_flops() == hand


def test_model_flops_match_the_published_count():
    # ultralytics lists 86.9 and 165.2 GFLOPs at 640 px (80 classes); the
    # 5-class heads are a little smaller
    assert 86.0e9 < counts.model_flops("yolo11l", 5, 640) < 87.0e9
    assert 164.0e9 < counts.model_flops("yolov8l", 5, 640) < 165.5e9
    fwd = counts.model_flops("yolo11n", 5, 64)
    assert 2.5 * fwd < counts.model_flops("yolo11n", 5, 64, True) < 4 * fwd


def test_epilogue_bytes_by_hand():
    shapes = counts.conv_outputs("yolo11n", 5, 2, 64)
    # stem: 3x3 stride 2 to 16 channels; 173 convs in yolo11l
    assert shapes[0] == (2, 16, 32, 32)
    assert len(counts.conv_outputs("yolo11l", 5, 1, 64)) == 173
    hand = sum(b * c * h * w * 6 + c * 4 for b, c, h, w in shapes)
    assert counts.epilogue_bytes("yolo11n", 5, 2, 64) == hand
    assert counts.plane_bytes(32, 512, 512, 2) == 32 * 512 * 512 * 8


def test_share_against_the_peaks():
    nbytes = counts.PEAKS["hbm_bytes_per_s"] * 1e-3
    assert abs(counts.share(nbytes, 2e-3) - 50.0) < 1e-9
    assert counts.share(nbytes, 0.0) is None
