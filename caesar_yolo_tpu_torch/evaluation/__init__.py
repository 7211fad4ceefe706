"""Dataset-quality evaluation: completeness / reliability / F1 / mAP."""

from caesar_yolo_tpu_torch.evaluation.evaluate import (
    evaluate_dataset,
    read_filelist,
)
from caesar_yolo_tpu_torch.evaluation.metrics import (
    SOURCE_CLASSES,
    SPECIAL_CLASSES,
    ClassCounts,
    MAPReport,
    MetricsReport,
    compute_completeness,
    compute_map,
    compute_metrics,
    compute_reliability,
    read_yolo_labels,
)

__all__ = [
    "ClassCounts", "MAPReport", "MetricsReport", "SOURCE_CLASSES",
    "SPECIAL_CLASSES", "compute_completeness", "compute_map",
    "compute_metrics", "compute_reliability", "evaluate_dataset",
    "read_filelist", "read_yolo_labels",
]
