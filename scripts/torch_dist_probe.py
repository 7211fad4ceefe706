#!/usr/bin/env python3
"""Which collectives gloo and NCCL take on the card, and how long each took.

Two gloo ranks share cuda:0 (NCCL refuses two ranks on one device), then
one NCCL rank: all_gather of uint8, int64, f64, f32 and uint64 tensors,
all_gather_into_tensor, all_reduce of small and of 25M-element f32 tensors
(three times), broadcast, an all_gather of CPU tensors and a barrier.
Each rank prints one JSON line: per operation "ok" with its result and
seconds (host clock around the call and a synchronize), or "FAIL" with the
error.  Prints the card's name and power limit last.

Run from the repository root on a CUDA card:
    python3 scripts/torch_dist_probe.py
"""

import json
import os
import socket
import subprocess
import sys
import time


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def worker(rank: int, world: int, backend: str) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group(backend, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    dev = torch.device("cuda:0")
    out = {}

    def probe(name, fn):
        """Record fn()'s result and time, or the error it raised."""
        try:
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            out[name] = ["ok", r, time.perf_counter() - t0]
        except (RuntimeError, TypeError, ValueError) as e:
            out[name] = ["FAIL", repr(e)[:300]]

    def gather(dtype, device=dev):
        x = torch.full((8,), rank + 1, dtype=dtype, device=device)
        got = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(got, x)
        return [int(g[0]) for g in got]

    def gather_into():
        x = torch.full((4,), rank + 1.0, dtype=torch.float64, device=dev)
        y = torch.empty(world * 4, dtype=torch.float64, device=dev)
        dist.all_gather_into_tensor(y, x)
        return y.tolist()

    def reduce(n, dtype):
        x = torch.full((n,), rank + 1.0, dtype=dtype, device=dev)
        dist.all_reduce(x)
        return float(x[0])

    def broadcast():
        x = torch.full((1000,), float(rank), device=dev)
        dist.broadcast(x, 0)
        return float(x.sum())

    def barrier():
        if backend == "nccl":
            dist.barrier(device_ids=[0])
        else:
            dist.barrier()
        return 0

    for dtype in (torch.uint8, torch.int64, torch.float64, torch.float32,
                  torch.uint64):
        probe(f"all_gather {dtype}", lambda d=dtype: gather(d))
    probe("all_gather_into_tensor f64", gather_into)
    probe("all_reduce f32 small", lambda: reduce(4, torch.float32))
    probe("all_reduce f64 small", lambda: reduce(4, torch.float64))
    for i in range(3):
        probe(f"all_reduce f32 25M #{i}",
              lambda: reduce(25_000_000, torch.float32))
    probe("broadcast f32", broadcast)
    probe("all_gather cpu uint8",
          lambda: gather(torch.uint8, torch.device("cpu")))
    probe("barrier", barrier)
    dist.destroy_process_group()
    print(json.dumps({"backend": backend, "rank": rank, "world": world,
                      "torch": torch.__version__, "ops": out}))


def main() -> int:
    for backend, world in (("gloo", 2), ("nccl", 1)):
        env = dict(os.environ, MASTER_ADDR="localhost",
                   MASTER_PORT=str(free_port()))
        procs = [subprocess.Popen(
            [sys.executable, __file__, str(r), str(world), backend],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(world)]
        for p in procs:
            print(p.communicate(timeout=300)[0][-6000:])
            print("rc", p.returncode)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1:
        worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
        sys.exit(0)
    sys.exit(main())
