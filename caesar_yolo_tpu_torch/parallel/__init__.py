"""The batched tile-detection engine, the mosaic source finder, and the
process-group helpers of multi-GPU runs (one process per GPU)."""

from caesar_yolo_tpu_torch.parallel.mesh import (
    all_reduce_sum,
    allgather_bytes,
    barrier,
    initialize_distributed,
    local_device,
    pad_to_multiple,
    process_count,
    process_index,
)

__all__ = ["all_reduce_sum", "allgather_bytes", "barrier",
           "initialize_distributed", "local_device", "pad_to_multiple",
           "process_count", "process_index"]
