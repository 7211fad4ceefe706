"""Greedy-NMS suppression (kernel K1).

Counterpart of caesar_yolo_tpu/detect/pallas_nms.py.  `nms_suppress`
returns the greedy keep mask of score-sorted, class-offset candidates:
the fixpoint of alive_i = valid_i & !any_{j<i}(alive_j & iou[j,i] > thr).

On a CUDA tensor it launches the hand-written kernels in csrc/nms.cu: an
IoU kill bitmask built across the card into a device buffer, then a
greedy scan of 32 rows a step by one warp an image, from shared memory
(see the source for its design and bound).  On a CPU tensor it
runs `suppress_plain`, the reference's XLA fixpoint sweeps
(caesar_yolo_tpu/detect/nms.py:_suppress_xla) in PyTorch.  Both give
bit-identical masks.

Under torch.export the wrapper calls the op caesar_yolo::nms_suppress
(utils/portable.py), whose body is the same dispatch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from caesar_yolo_tpu_torch import cuda_build
from caesar_yolo_tpu_torch.utils import portable
from caesar_yolo_tpu_torch.utils.boxes import iou_matrix

MAX_K = 8192    # candidates an image the kernel takes (csrc/nms.cu kMaxK)


def suppress_plain(nms_boxes: torch.Tensor, valid: torch.Tensor,
                   iou_thr: float) -> torch.Tensor:
    """nms_boxes [B, K, 4] f32, valid [B, K] bool -> alive [B, K] bool,
    by fixpoint sweeps over the materialised [K, K] IoU matrix."""
    k = nms_boxes.shape[1]
    iou = iou_matrix(nms_boxes, nms_boxes)
    js = torch.arange(k, device=nms_boxes.device)
    higher = js[:, None] < js[None, :]
    thr = torch.tensor(iou_thr, dtype=torch.float32)
    suppress = ((iou > thr) & higher & valid[:, :, None]
                & valid[:, None, :])
    alive = valid
    while True:
        killed = (suppress & alive[:, :, None]).any(dim=1)
        new_alive = valid & ~killed
        if torch.equal(new_alive, alive):
            return alive
        alive = new_alive


def nms_suppress(boxes_t: torch.Tensor, valid: torch.Tensor,
                 iou_thr: float) -> torch.Tensor:
    """boxes_t [B, 4, K] f32 (x1, y1, x2, y2 rows, score-descending along
    K, class offsets applied), valid [B, K] bool -> alive [B, K] bool.

    CUDA tensors launch the kernels (the mask, then the scan: two CUDA
    launches, counted as one in `nms_suppress.launches`, once a call) and
    use a [B, K, ceil(K/32)] int32 scratch mask; CPU tensors take
    `suppress_plain`."""
    if portable.exporting():
        return torch.ops.caesar_yolo.nms_suppress(boxes_t, valid,
                                                  float(iou_thr))
    if not boxes_t.is_cuda:
        return suppress_plain(boxes_t.transpose(1, 2), valid, iou_thr)
    b, four, k = boxes_t.shape
    if (four != 4 or boxes_t.dtype != torch.float32
            or valid.shape != (b, k) or valid.dtype != torch.bool):
        raise ValueError(f"nms kernel does not take boxes "
                         f"{tuple(boxes_t.shape)} {boxes_t.dtype}, valid "
                         f"{tuple(valid.shape)} {valid.dtype}")
    if k > MAX_K:
        raise ValueError(f"nms kernel takes at most {MAX_K} candidates, "
                         f"not {k}")
    boxes_t = boxes_t.contiguous()
    valid = valid.contiguous()
    alive = torch.empty((b, k), dtype=torch.bool, device=boxes_t.device)
    mask = torch.empty((b * k * (-(-k // 32)),), dtype=torch.int32,
                       device=boxes_t.device)
    nms_suppress.launches += 1
    cuda_build.check(_entry()(boxes_t.data_ptr(), valid.data_ptr(),
                              alive.data_ptr(), mask.data_ptr(), b, k,
                              float(iou_thr),
                              cuda_build.stream_ptr(boxes_t.device)),
                     "nms kernel")
    return alive


@functools.cache
def _entry():
    """The C entry point, its argument types set once."""
    fn = cuda_build.load("nms").cy_nms_suppress
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


cuda_build.counters(nms_suppress, "launches")


@torch.library.custom_op("caesar_yolo::nms_suppress", mutates_args=())
def _nms_suppress_op(boxes_t: torch.Tensor, valid: torch.Tensor,
                     iou_thr: float) -> torch.Tensor:
    # a copy where the plain sweeps end on their first pass and return
    # `valid` itself: an op's output may not be its input
    alive = nms_suppress(boxes_t, valid, iou_thr)
    if alive is valid:
        return alive.clone(memory_format=torch.contiguous_format)
    return alive.contiguous()


@_nms_suppress_op.register_fake
def _(boxes_t, valid, iou_thr):
    return boxes_t.new_empty((boxes_t.shape[0], boxes_t.shape[2]),
                             dtype=torch.bool)
