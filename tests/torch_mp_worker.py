"""One rank of the port's multi-process runs (not a test module): launched
as a subprocess by tests/test_torch_multiprocess.py (gloo on the CPU) and
by chip_smoke.py's multiproc phase (the card).  Imports nothing of JAX.

    python tests/torch_mp_worker.py SPEC.json RANK

SPEC (JSON) holds the run: "mode" ("tiled", "train", "cli_train" or
"units"), "world" (processes), "init" (the group's init_method, e.g.
file://...; "env": the launcher's environment, as under torchrun; null for
one process without a group), "backend" (null: by the device), "device"
(null: this process's GPU), "out" (the directory of the result file
<mode>_rank<RANK>_n<world>.json), "timeout_s", "threads", and per mode:

  tiled  "workdir" (the run's working directory, where rank 0 writes the
         catalog) and either "argv" (cli.run's arguments) or "sfinder"
         (SFinderConfig fields) with "weights", "preproc"
         (build_preprocessor's arguments) and "compute_dtype";
         "gather_payload_bytes" sets the gather's chunk in both
  train  "weights" (a reference npz) or "model" and "seed" (seeded
         weights), "batch": "golden" (test_torch_train_golden's batch) or
         [n, size] (its make_batch), "roll" (the batch's rows rolled by
         that many, an order control), "augment" (a seed: the batch is
         augmented once by augment_batch with the global batch's draws),
         "steps", "summary_after" (the steps the golden summary covers),
         "compute_dtype", and "bf16_profile" (then bf16 steps: timed,
         the gradient all-reduce timed, profiled)
  cli_train
         "argv" (cli.train's arguments)
  units  synchronized BatchNorm on rows of a seeded batch, and
         allgather_bytes with an empty rank and with nothing at all

The result records the kernel launches each rank made in its run.  A
rank of a group meets the others at a barrier before it writes it.
"""

import contextlib
import hashlib
import json
import os
import sys
import time
import traceback
from dataclasses import replace

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def kernel_launches() -> dict:
    """{kernel: launches so far} of every wrapper of the port's kernels."""
    from caesar_yolo_tpu_torch.detect import cuda_nms
    from caesar_yolo_tpu_torch.models import cuda_attn, cuda_epilogue
    from caesar_yolo_tpu_torch.ops import (cuda_histeq, cuda_preproc,
                                           cuda_shift, cuda_stats,
                                           cuda_upsample)
    fns = {"nms": cuda_nms.nms_suppress, "attn": cuda_attn.attention,
           "attn_bwd": cuda_attn.attention_backward,
           "preproc": cuda_preproc.zscale_minmax,
           "stats": cuda_stats.clip_stats,
           "histeq": cuda_histeq.equalize_hist_batch,
           "upsample": cuda_upsample.upsample2x_forward,
           "upsample_bwd": cuda_upsample.upsample2x_backward,
           "shift": cuda_shift.fractional_row_shift_batch,
           "epilogue": cuda_epilogue.conv_epilogue}
    return {k: int(f.launches) for k, f in fns.items()}


def digest(state: dict) -> tuple[str, list]:
    """(sha256 of every tensor's bytes in key order, each tensor's f64
    sum)."""
    h = hashlib.sha256()
    sums = []
    for k in sorted(state):
        a = state[k].detach().cpu().contiguous().numpy()
        h.update(a.tobytes())
        sums.append(float(a.astype(np.float64).sum()))
    return h.hexdigest(), sums


def run_tiled(spec, rank, device):
    import torch

    from caesar_yolo_tpu_torch.cli import run as cli_run
    from caesar_yolo_tpu_torch.models.convert import load_model
    from caesar_yolo_tpu_torch.ops.transforms import build_preprocessor
    from caesar_yolo_tpu_torch.parallel.sfinder import SFinder, SFinderConfig

    cap = spec.get("gather_payload_bytes")
    before = kernel_launches()
    t0 = time.perf_counter()
    if "argv" in spec:
        if cap:
            config_from_args = cli_run.config_from_args
            cli_run.config_from_args = lambda args: replace(
                config_from_args(args), gather_payload_bytes=cap)
        with contextlib.chdir(spec["workdir"]):
            rc, sf = cli_run.run(spec["argv"])
    else:
        model, _ = load_model(spec["weights"])
        cfg = SFinderConfig(**spec["sfinder"])
        if cap:
            cfg = replace(cfg, gather_payload_bytes=cap)
        sf = SFinder(model, cfg,
                     preprocessor=build_preprocessor(**spec["preproc"]),
                     engine_kwargs={"compute_dtype": getattr(
                         torch, spec["compute_dtype"])}, device=device)
        with contextlib.chdir(spec["workdir"]):
            rc = sf.run_tiled()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = kernel_launches()
    r = sf.report
    return {"rc": rc, "wall_s": wall, "runtime_s": r.runtime_s,
            "n_tiles": r.n_tiles, "n_local_tiles": r.n_local_tiles,
            "gather_rounds": r.gather_rounds, "gather_bytes": r.gather_bytes,
            "tiling_mode": r.tiling_mode, "phase_times": r.phase_times,
            "device": str(sf.device), "sources": sf.sources["sources"],
            "launches": {k: after[k] - before[k] for k in after}}


def train_batch(spec):
    import test_torch_train_golden as golden_train
    if spec["batch"] == "golden":
        return golden_train.as_train_batch(golden_train.load_golden())
    n, size = spec["batch"]
    tiles, labels, boxes, mask = golden_train.make_batch(n=n, size=size)
    return np.repeat(tiles, 3, axis=-1), labels, boxes, mask


def resolution(final: dict, keys) -> list:
    """Per tensor, the f32 resolution of its weights' update norm:
    sqrt(n) * spacing(max |w|), the norm of a one-ulp difference in every
    element."""
    return [float(np.sqrt(final[k].size)
                  * np.spacing(np.abs(final[k]).max().astype(np.float32)))
            for k in keys]


def run_train(spec, rank, device):
    import torch

    import test_torch_train_golden as golden_train
    from caesar_yolo_tpu_torch.models.convert import flat_params, load_model
    from caesar_yolo_tpu_torch.models.yolo import build_model, init_weights
    from caesar_yolo_tpu_torch.parallel import mesh
    from caesar_yolo_tpu_torch.train.trainer import TrainConfig, Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if spec.get("weights"):
        model, _ = load_model(spec["weights"])
    else:
        model = init_weights(build_model(spec["model"], num_classes=5),
                             seed=spec["seed"])
    init = flat_params(model.state_dict())
    batch = train_batch(spec)
    n = len(batch[0])
    order = np.roll(np.arange(n), spec.get("roll", 0))
    batch = tuple(a[order] for a in batch)
    nproc = mesh.process_count()
    rows = slice(rank * n // nproc, (rank + 1) * n // nproc)
    local = tuple(a[rows] for a in batch)
    cfg = dict(golden_train.CONFIG, batch_size=n,
               img_size=int(batch[0].shape[1]),
               compute_dtype=spec["compute_dtype"])
    trainer = Trainer(model, TrainConfig(**cfg),
                      steps_per_epoch=golden_train.STEPS_PER_EPOCH,
                      device=device)
    before = kernel_launches()
    if spec.get("augment") is not None:
        from caesar_yolo_tpu_torch.train.augment import (augment_batch,
                                                         draw_augment_params)
        draws = tuple(d[torch.from_numpy(order)] for d in draw_augment_params(
            torch.Generator().manual_seed(spec["augment"]), n))
        imgs, boxes, masks = augment_batch(
            torch.from_numpy(local[0]).to(trainer.device),
            torch.from_numpy(local[2]), torch.from_numpy(local[3]),
            *(d[rows] for d in draws))
        local = (imgs, local[1], boxes, masks)
    losses, summary = [], None
    t0 = time.perf_counter()
    for i in range(spec["steps"]):
        loss, parts = trainer.train_step(*local)
        losses.append((loss.item(), {k: v.item() for k, v in parts.items()}))
        if i + 1 == spec.get("summary_after"):
            final = flat_params(trainer.model.state_dict())
            summary = golden_train.summarise(init, final, losses)
            summary["resolution"] = np.asarray(
                resolution(final, summary["norm_keys"]))
    wall = time.perf_counter() - t0
    after = kernel_launches()
    phash, psums = digest(trainer.model.state_dict())
    ehash, esums = digest(trainer.ema)
    out = {"losses": [l for l, _ in losses], "parts": [p for _, p in losses],
           "params_hash": phash, "ema_hash": ehash, "param_sums": psums,
           "ema_sums": esums, "step": trainer.step, "wall_s": wall,
           "device": str(trainer.device),
           "launches": {k: after[k] - before[k] for k in after}}
    if summary is not None:
        out["summary"] = {k: v.tolist() for k, v in summary.items()}
    if spec.get("bf16_profile"):
        out["bf16"] = bf16_step(model, cfg, local, device)
    return out


def bf16_step(model, cfg, local, device):
    """bf16 steps after a warm-up: one step's wall time and the
    collectives it made; the gradient all-reduce's time in another, timed
    between two synchronizations; and under torch.profiler the host time
    in the trainer's train.grad_all_reduce span of a third, from the
    span recorder (utils/trace.py) the trainer is given for that step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from caesar_yolo_tpu_torch.parallel import mesh
    from caesar_yolo_tpu_torch.train.trainer import TrainConfig, Trainer
    from caesar_yolo_tpu_torch.utils.trace import Recorder

    trainer = Trainer(model, TrainConfig(**dict(
        cfg, compute_dtype="bfloat16")), steps_per_epoch=2, device=device)

    def step():
        trainer.train_step(*local)
        if trainer.device.type == "cuda":
            torch.cuda.synchronize()

    step()
    calls = sum(mesh.collectives.values())
    t0 = time.perf_counter()
    step()
    step_s = time.perf_counter() - t0
    calls = sum(mesh.collectives.values()) - calls
    reduce_s = []
    all_reduce_sum = mesh.all_reduce_sum

    def timed(t):
        """The all-reduce of the flat gradient buffer, timed alone."""
        if t.numel() < 1_000_000:
            return all_reduce_sum(t)
        sync = torch.cuda.synchronize if t.is_cuda else (lambda: None)
        sync()
        t0 = time.perf_counter()
        all_reduce_sum(t)
        sync()
        reduce_s.append(time.perf_counter() - t0)
        return t

    mesh.all_reduce_sum = timed
    try:
        step()
    finally:
        mesh.all_reduce_sum = all_reduce_sum
    trainer.recorder = recorder = Recorder()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if trainer.device.type == "cuda" else [])
    with profile(activities=acts):
        t0 = time.perf_counter()
        step()
        prof_step_s = time.perf_counter() - t0
    span_s = recorder.totals().get("train.grad_all_reduce")
    return {"step_s": step_s, "collectives_per_step": calls,
            "grad_all_reduce_s": reduce_s[0] if reduce_s else None,
            "grad_all_reduce_share": (reduce_s[0] / step_s if reduce_s
                                      else None),
            "profiled_step_s": prof_step_s,
            "profiled_span_s": span_s,
            "grad_bytes": 4 * sum(p.numel() for p in trainer.params.values())}


def run_cli_train(spec, rank, device):
    from caesar_yolo_tpu_torch.cli import train as cli_train
    rc, trainer = cli_train.run(spec["argv"])
    phash, psums = digest(trainer.model.state_dict())
    ehash, esums = digest(trainer.ema)
    return {"rc": rc, "step": trainer.step, "params_hash": phash,
            "ema_hash": ehash, "param_sums": psums, "ema_sums": esums,
            "losses": [float(loss) for _, loss in trainer.loss_log],
            "best_metric": trainer.best_metric}


def bn_case(n: int):
    """A seeded Conv (3 -> 8 channels, BN and SiLU) in train mode, a batch
    x [n, 3, 6, 5] and a cotangent of its output."""
    import torch

    from caesar_yolo_tpu_torch.models.layers import Conv
    g = torch.Generator().manual_seed(3)
    x = torch.randn(n, 3, 6, 5, generator=g) * 2 + 1
    cot = torch.randn(n, 8, 6, 5, generator=g)
    conv = Conv(3, 8, 3)
    with torch.no_grad():
        conv.w.copy_(torch.randn(conv.w.shape, generator=g))
        conv.bn.gamma.copy_(torch.rand(8, generator=g) + 0.5)
        conv.bn.beta.copy_(torch.randn(8, generator=g))
    return conv, x, cot


def bn_forward_backward(conv, x, cot):
    """(y, dL/dx, dL/dw) of L = sum(y * cot), y = conv(x) in train mode."""
    from caesar_yolo_tpu_torch.models.layers import train_mode
    x = x.clone().requires_grad_(True)
    with train_mode(conv):
        y = conv(x)
    (y * cot).sum().backward()
    return y.detach(), x.grad, conv.w.grad


def gather_blob(rank: int) -> bytes:
    """The units' allgather payload: 200 bytes times (rank + 1) on even
    ranks, nothing on odd ones."""
    return bytes(range(7, 7 + 200)) * (rank + 1) if rank % 2 == 0 else b""


def run_units(spec, rank, device):
    """Synchronized BatchNorm (forward, input and weight gradients) on
    this rank's rows of bn_case's batch; allgather_bytes with the odd
    ranks empty, and with every rank empty; a second initialize call."""
    from caesar_yolo_tpu_torch.parallel import mesh

    nproc = mesh.process_count()
    conv, x, cot = bn_case(4 * nproc)
    rows = slice(rank * 4, rank * 4 + 4)
    y, x_grad, w_grad = bn_forward_backward(conv, x[rows], cot[rows])
    rows_got, rounds = mesh.allgather_bytes(gather_blob(rank), 64)
    none_got, none_rounds = mesh.allgather_bytes(b"", 64)
    return {"y": y.tolist(), "x_grad": x_grad.tolist(),
            "w_grad": w_grad.tolist(),
            "reinit": mesh.initialize_distributed(spec["init"], nproc, rank),
            "gathered": [r.hex() for r in rows_got], "rounds": rounds,
            "empty": [r.hex() for r in none_got], "empty_rounds": none_rounds}


def main():
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    rank = int(sys.argv[2])
    import datetime

    import torch

    from caesar_yolo_tpu_torch.parallel import mesh

    torch.set_num_threads(int(spec.get("threads", 2)))
    kw = dict(backend=spec.get("backend"), device=spec.get("device"),
              timeout=datetime.timedelta(seconds=spec.get("timeout_s", 300)))
    if spec.get("init") == "env":
        mesh.initialize_distributed(**kw)
    elif spec.get("init"):
        mesh.initialize_distributed(spec["init"], spec["world"], rank, **kw)
    run = {"tiled": run_tiled, "train": run_train,
           "cli_train": run_cli_train, "units": run_units}[spec["mode"]]
    out = run(spec, rank, spec.get("device"))
    out.update(rank=rank, world=mesh.process_count(), pid=os.getpid(),
               backend=(torch.distributed.get_backend()
                        if mesh.distributed() else None),
               collectives=dict(mesh.collectives))
    if mesh.distributed():
        mesh.barrier()
    path = os.path.join(spec["out"],
                        f"{spec['mode']}_rank{rank}_n{spec['world']}.json")
    with open(path, "w") as f:
        json.dump(out, f, sort_keys=True)
    if mesh.distributed():
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
