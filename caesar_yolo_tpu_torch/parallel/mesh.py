"""Process-group helpers for multi-GPU runs: one process per GPU.

Counterpart of caesar_yolo_tpu/parallel/mesh.py.  The reference farms
tiles to MPI ranks, one GPU each (reference inference.py:992-1162); the
JAX package stripes them over `jax.distributed` processes and gathers the
per-tile results by a chunked allgather (sfinder._gather_multihost).  The
port keeps that shape with torch.distributed, the PyTorch idiom: a launcher
(`torchrun --nproc_per_node=N`) starts one process per GPU, and each
process runs on `cuda:{LOCAL_RANK}`.  JAX's in-process mesh over several
local chips (`make_mesh`, `local_mesh`, `batch_sharding`) has no
counterpart: one process per GPU covers the same hardware.

The backend follows the rank's device: NCCL for a CUDA device, gloo for
the CPU (the tests).  `initialize_distributed(backend="gloo")` puts several
ranks on one card, which NCCL refuses.  Every collective waits at most
`GROUP_TIMEOUT`, so a rank that dies fails its peers instead of hanging
them.  Each wrapper counts its calls in `collectives`.
"""

from __future__ import annotations

import datetime
import os
from collections import Counter

import torch
import torch.distributed as dist

from caesar_yolo_tpu_torch import logger

GROUP_TIMEOUT = datetime.timedelta(seconds=300)

# calls of each collective wrapper below, by name
collectives: Counter = Counter()


def distributed() -> bool:
    """Whether this process belongs to a process group."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank (jax.process_index): 0 without a group."""
    return dist.get_rank() if distributed() else 0


def process_count() -> int:
    """The number of processes (jax.process_count): 1 without a group."""
    return dist.get_world_size() if distributed() else 1


def backend_for(device) -> str:
    """NCCL for a CUDA device (the default device is CUDA), gloo for the
    CPU."""
    return "nccl" if torch.device(device or "cuda").type == "cuda" else "gloo"


def local_device() -> torch.device:
    """This process's GPU: cuda:{LOCAL_RANK} (the launcher's; without it,
    the rank).  Raises when there is no such device: a rank never falls
    back to the CPU or to another GPU on its own."""
    local = os.environ.get("LOCAL_RANK")
    local = process_index() if local is None else int(local)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if local >= n:
        raise RuntimeError(
            f"local rank {local} has no GPU ({n} visible); launch at most "
            f"one process per GPU, or pass the device explicitly "
            f"(--devices=cuda:K or --devices=cpu)")
    return torch.device("cuda", local)


def initialize_distributed(init_method: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None,
                           backend: str | None = None, *, device=None,
                           timeout: datetime.timedelta = GROUP_TIMEOUT
                           ) -> bool:
    """Join the process group (idempotent) -> whether a group is up.

    A no-op without arguments outside a launcher (WORLD_SIZE unset or 1),
    as JAX's is without a coordinator.  Under `torchrun` the rank, world
    size and rendezvous come from the environment; `init_method`,
    `world_size` and `rank` name them instead (a `file://` path or a
    `tcp://host:port`).  The backend is NCCL when `device` (default: this
    process's GPU) is CUDA and gloo when it is the CPU, unless named."""
    if distributed():
        return True
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    if init_method is None and world_size is None and env_world <= 1:
        return False
    world_size = env_world if world_size is None else world_size
    rank = int(os.environ.get("RANK", "0")) if rank is None else rank
    backend = backend or backend_for(device)
    if backend == "nccl":
        # NCCL binds its communicator to the current GPU: the named one,
        # else cuda:{LOCAL_RANK} (without it, the rank)
        dev = torch.device(device or "cuda")
        if dev.index is None:
            dev = torch.device("cuda",
                               int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timeout)
    logger.info("Process group: rank %d of %d (%s)", rank, world_size,
                backend)
    return True


def _comm_device() -> torch.device:
    """Where a collective's own buffers live: the current GPU for NCCL,
    the CPU for gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather(t: torch.Tensor) -> list[torch.Tensor]:
    """Every rank's `t` (same shape and dtype on every rank), in rank
    order."""
    collectives["all_gather"] += 1
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t.contiguous())
    return out


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum `t` over the ranks in place; returns it."""
    collectives["all_reduce"] += 1
    dist.all_reduce(t)
    return t


def broadcast_(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Overwrite `t` with rank `src`'s in place; returns it."""
    collectives["broadcast"] += 1
    dist.broadcast(t, src)
    return t


def barrier() -> None:
    """Wait until every rank arrives."""
    collectives["barrier"] += 1
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def allgather_bytes(blob: bytes, cap: int) -> tuple[list[bytes], int]:
    """Every rank's `blob`, in rank order, and the rounds it took: the
    chunked allgather of the JAX SFinder (_gather_multihost).  Round 0
    gathers the lengths; then ceil(maxlen / size) rounds of size =
    min(cap, maxlen) bytes each.  Every rank derives the same schedule from
    the same lengths, so a rank with nothing to send still joins every
    round, and a crowded catalog takes more rounds, never an error."""
    dev = _comm_device()
    # int64: the lengths' dtype on every backend (JAX gathers uint64)
    lens = [int(n) for n in torch.cat(all_gather(
        torch.tensor([len(blob)], dtype=torch.int64, device=dev))).tolist()]
    maxlen = max(lens)
    if maxlen == 0:
        return [b"" for _ in lens], 0
    size = min(cap, maxlen)
    nrounds = -(-maxlen // size)
    rows = [bytearray(n) for n in lens]
    src = torch.frombuffer(bytearray(blob), dtype=torch.uint8) if blob \
        else torch.zeros(0, dtype=torch.uint8)
    for r in range(nrounds):
        lo = r * size
        chunk = torch.zeros(size, dtype=torch.uint8)
        seg = src[lo:lo + size]
        chunk[:len(seg)] = seg
        got = all_gather(chunk.to(dev))
        for p, n in enumerate(lens):
            hi = min(lo + size, n)
            if hi > lo:
                rows[p][lo:hi] = got[p][:hi - lo].cpu().numpy().tobytes()
    return [bytes(r) for r in rows], nrounds


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k
