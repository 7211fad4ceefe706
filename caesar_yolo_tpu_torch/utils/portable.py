"""The export switch: what a trace for a serving artifact sees.

Counterpart of caesar_yolo_tpu/utils/portable.py (its FORCE flag, set by
deploy.export_detector's `portable_suppression`).  There the flag makes
every Pallas call site trace its XLA formulation, so that an artifact
lowers for every platform.  Here the question is the converse: the
port's kernel wrappers launch through ctypes on `data_ptr()`, which a
fake tensor has not, and some plain versions loop on their data, which
export refuses.  So while `exporting()` is True each wrapper calls its
`torch.ops.caesar_yolo` op instead (registered in the wrapper's own
module, with a fake that gives the output's shape, dtype and strides),
and the op's body, run when the artifact runs, is the wrapper's usual
dispatch: the kernel on a CUDA tensor, the plain version on a CPU one.
Outside export the wrappers launch directly: a call through an op costs
the host about 19.5 us more than a direct launch (41.82 against 22.35 us
on an H100, PERF.md section 6).
"""

from __future__ import annotations

import torch


def exporting() -> bool:
    """True while torch.export traces: the port's counterpart of
    caesar_yolo_tpu/utils/portable.py's FORCE, which the JAX package's
    portable_suppression sets for jax.export."""
    return torch.compiler.is_exporting()


def channels_last_on_cuda(t: torch.Tensor) -> torch.memory_format:
    """The memory format of a kernel that writes channels_last on the card
    (K4, K9, K10); their plain versions on the CPU write contiguous NCHW."""
    return (torch.channels_last if t.device.type == "cuda"
            else torch.contiguous_format)
