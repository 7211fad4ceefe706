"""Device selection for the port's entry points."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the one asked for, else this
    process's GPU under a process group (cuda:{LOCAL_RANK},
    parallel/mesh.local_device), else CUDA.  Raises when CUDA is wanted
    (explicitly or by default) and there is none -- an entry point never
    carries on on the CPU unasked."""
    from caesar_yolo_tpu_torch.parallel import mesh
    if device is None and mesh.distributed():
        return mesh.local_device()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return dev


@contextlib.contextmanager
def exact_f32():
    """Inside the block cuDNN's f32 convolutions and cuBLAS's f32 products
    round nothing to TF32 (cuDNN's default takes TF32 for an f32 conv);
    the previous settings come back after it.  No effect on the CPU."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = prev
