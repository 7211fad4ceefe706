"""Host utilities: box math, union-find, synthetic mosaics, device selection."""

from caesar_yolo_tpu_torch.utils.boxes import (
    get_iou,
    get_merged_bbox,
    iou_matrix,
    iou_matrix_np,
    xywh2xyxy,
    xyxy2xywh,
)
