"""Greedy-NMS suppression (kernel K1).

Counterpart of caesar_yolo_tpu/detect/pallas_nms.py.  `nms_suppress`
returns the greedy keep mask of score-sorted, class-offset candidates:
the fixpoint of alive_i = valid_i & !any_{j<i}(alive_j & iou[j,i] > thr).

On a CUDA tensor it launches the hand-written kernel in csrc/nms.cu (one
block per image: an IoU kill bitmask, then a sequential greedy scan by
one warp; see the source for its design and bound).  On a CPU tensor it
runs `suppress_plain`, the reference's XLA fixpoint sweeps
(caesar_yolo_tpu/detect/nms.py:_suppress_xla) in PyTorch.  Both give
bit-identical masks.
"""

from __future__ import annotations

import ctypes

import torch

from caesar_yolo_tpu_torch import cuda_build
from caesar_yolo_tpu_torch.utils.boxes import iou_matrix


def suppress_plain(nms_boxes: torch.Tensor, valid: torch.Tensor,
                   iou_thr: float) -> torch.Tensor:
    """nms_boxes [B, K, 4] f32, valid [B, K] bool -> alive [B, K] bool,
    by fixpoint sweeps over the materialised [K, K] IoU matrix."""
    k = nms_boxes.shape[1]
    iou = torch.vmap(iou_matrix)(nms_boxes, nms_boxes)
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

    CUDA tensors launch the kernel; CPU tensors take `suppress_plain`."""
    if not boxes_t.is_cuda:
        return suppress_plain(boxes_t.transpose(1, 2), valid, iou_thr)
    b, four, k = boxes_t.shape
    if (four != 4 or boxes_t.dtype != torch.float32
            or valid.shape != (b, k) or valid.dtype != torch.bool):
        raise ValueError(f"nms kernel does not take boxes "
                         f"{tuple(boxes_t.shape)} {boxes_t.dtype}, valid "
                         f"{tuple(valid.shape)} {valid.dtype}")
    boxes_t = boxes_t.contiguous()
    valid = valid.contiguous()
    alive = torch.empty((b, k), dtype=torch.bool, device=boxes_t.device)
    lib = cuda_build.load("nms")
    lib.cy_nms_scratch_words.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.cy_nms_scratch_words.restype = ctypes.c_longlong
    words = lib.cy_nms_scratch_words(b, k)
    scratch = torch.empty((max(words, 1),), dtype=torch.int32,
                          device=boxes_t.device)
    fn = lib.cy_nms_suppress
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    nms_suppress.launches += 1
    cuda_build.check(fn(boxes_t.data_ptr(), valid.data_ptr(),
                        alive.data_ptr(), scratch.data_ptr(), b, k,
                        float(iou_thr), cuda_build.stream_ptr(boxes_t.device)),
                     "nms kernel")
    return alive


nms_suppress.launches = 0
