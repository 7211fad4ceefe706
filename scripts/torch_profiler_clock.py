#!/usr/bin/env python3
"""How many kernel records torch.profiler keeps as a process ages, on one
CUDA card.

Every `step` seconds (the process idle in between) two functions are
profiled over 20 calls each: K9 at chip_smoke.py's timing shape
([32,128,40,40] bf16, 3x3, 128 channels out; about 0.58 ms a launch) and
an in-place add on 65536 floats (about a microsecond).  Each is profiled
in a bare session and in one opened by chip_smoke.PROFILE_PRIME spins (as
chip_smoke.kernel_split opens its sessions).  Each line prints the
records kept of 20 and the device time a call from what was kept, then
chip_smoke.device_ms (CUDA events, the calls queued behind a spin) and
chip_smoke.time_ms (CUDA events, launched as the host goes).

Usage: python3 scripts/torch_profiler_clock.py [rounds=6] [step=25]
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ITERS = 20
SHAPE = (32, 128, 128, 40, 40, 3, 1, "bfloat16", "channels_last")


def session(torch, fn, prime):
    """(records kept, their device ms over ITERS) of ITERS calls in one
    profiler session opened by `prime` 1000-cycle spins (left out)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(prime):
            torch.cuda._sleep(1000)
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    kept = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "spin_kernel" not in e.name]
    return len(kept), sum(e.device_time_total for e in kept) / 1e3 / ITERS


def main() -> int:
    import torch

    import chip_smoke as cs
    from caesar_yolo_tpu_torch.models import cuda_qconv

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    step = float(sys.argv[2]) if len(sys.argv) > 2 else 25.0
    x, wq, ws, xs, b = cs.qconv_case(torch, SHAPE, "cuda", 0)
    small = torch.zeros(1 << 16, device="cuda")
    fns = {"K9": lambda: cuda_qconv.qconv(x, wq, ws, xs, b, 1, 1, True),
           "add": lambda: small.add_(1.0)}
    t0 = time.perf_counter()
    for r in range(rounds + 1):
        if r:
            time.sleep(step)
        for name, fn in fns.items():
            bare = session(torch, fn, 0)
            primed = session(torch, fn, cs.PROFILE_PRIME)
            print(f"t={time.perf_counter() - t0:.0f} s {name}: bare session "
                  f"kept {bare[0]}/{ITERS} records ({bare[1]:.5f} ms a "
                  f"call); primed {primed[0]}/{ITERS} ({primed[1]:.5f}); "
                  f"device_ms {cs.device_ms(torch, fn, ITERS):.5f}; "
                  f"time_ms {cs.time_ms(torch, fn, iters=ITERS):.5f}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
