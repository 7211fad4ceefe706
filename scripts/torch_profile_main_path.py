#!/usr/bin/env python3
"""Where the device time of the PyTorch port's main paths goes.

Runs the chip_smoke.py main path (yolo11l at 640 px, bf16, seeded
weights, README preprocessing, batches of 32 synthetic 640 px tiles);
with --path=mosaic, the tile engine of its mosaic phase (batches of 32
synthetic 512 px tiles, background subtraction + chan3 + min-max to
[0, 255]); or, with --path=train, training steps of its training phase
(yolo11l at 640 px, bf16 compute, batch 16, augment_batch then
Trainer.train_step on synthetic images with 1-3 gt boxes each) on one
CUDA card under torch.profiler and prints:
  - the card's name and power limit;
  - wall time per batch, device-busy time per batch and the device's
    idle share over the profiled window;
  - device time by category (convolution/GEMM library kernels, the
    port's own kernels, everything else) and the top kernels by name;
  - without the profiler, the forward pass's time in channels_last (what
    the engine uses on CUDA) and in plain NCHW memory, alternating
    A B B A, by CUDA events (main path);
  - without the profiler, a training step split into augmentation,
    forward + loss, backward and optimizer update by synchronised host
    clocks (train path).

Run from the repository root:
    python3 scripts/torch_profile_main_path.py [--path=main|mosaic|train]
"""

from __future__ import annotations

import copy
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

BATCH, BATCHES, SIZE = 32, 4, 640
TRAIN_BATCH = 16
MOSAIC_TILE = 512
PORT_KERNELS = ("attn_fwd_mma_kernel",
                "attn_fwd_kernel", "zlims_init_kernel", "reduce_kernel",
                "apply_kernel", "minmax_kernel", "hist_kernel", "init_kernel",
                "attn_bwd_dq_mma_kernel", "attn_bwd_dkdv_mma_kernel",
                "attn_bwd_dq_kernel", "attn_bwd_dkdv_kernel",
                "up2_fwd_kernel", "up2_bwd_kernel", "row_shift_kernel",
                "col_shift_kernel", "histeq_cluster_kernel",
                "zscale_cluster_kernel", "clahe_cluster_kernel",
                "range_kernel", "tables_kernel", "blend_kernel",
                "epilogue_kernel", "quantize_kernel", "qgemm_kernel")
LIBRARY_MARKS = ("conv", "gemm", "cudnn", "cutlass", "xmma", "sm90_",
                 "implicit", "winograd", "fprop", "nhwc")


def category(name: str) -> str:
    low = name.lower()
    # PyTorch's own kernels share some of the port's kernel names
    # (reduce_kernel, apply_kernel, init_kernel)
    own = "at::native" not in name
    if own and "clip_stats_cluster_kernel" in name:
        return "port kernel K5 (sigma-clip stats)"
    if own and ("nms_mask_kernel" in name or "nms_scan_kernel" in name):
        return "port kernel K1 (NMS: mask, scan)"
    if own and any(k in name for k in PORT_KERNELS):
        return "port kernels (K2-K4, K6-K8)"
    if any(k in low for k in LIBRARY_MARKS):
        return "convolution / GEMM (cuDNN, cuBLAS)"
    return "other PyTorch kernels"


def main() -> int:
    import argparse

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    parser = argparse.ArgumentParser()
    parser.add_argument("--path", choices=["main", "mosaic", "train"],
                        default="main")
    path = parser.parse_args().path
    mosaic = path == "mosaic"

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())

    from caesar_yolo_tpu_torch.models.yolo import build_model, init_weights
    if path == "train":
        return profile_train(torch, profile, ProfilerActivity, np)
    from caesar_yolo_tpu_torch.ops.transforms import build_preprocessor
    from caesar_yolo_tpu_torch.parallel.engine import TileEngine
    from caesar_yolo_tpu_torch.utils.synth import make_mosaic

    if mosaic:
        pre = build_preprocessor(subtract_bkg=True, chan3_preproc=True,
                                 sigma_clip_baseline=0.0, sigma_clip_low=1.0,
                                 sigma_clip_up=20.0, normalize_minmax=True,
                                 norm_max=255.0)
        tile = MOSAIC_TILE
    else:
        pre = build_preprocessor(zscale_stretch=True, normalize_minmax=True)
        tile = SIZE
    engine = TileEngine(init_weights(build_model("yolo11l"), seed=0),
                        preprocessor=pre, img_size=SIZE, score_thr=1e-3,
                        iou_thr=0.5)
    tiles = np.stack([make_mosaic(tile, tile, n_sources=25, seed=1000 + i)[0]
                      for i in range(BATCH)])[..., None]
    staged = engine.put_tiles(tiles)
    for _ in range(2):
        engine.process_async(staged)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(BATCHES):
            engine.process_async(staged)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    if report(torch, prof, wall, f"{'mosaic' if mosaic else 'main'} path "
              f"({tile} px tiles) yolo11l@{SIZE} bf16 batch {BATCH}",
              "batch") != 0:
        return 1
    if mosaic:
        return 0

    x = torch.rand(BATCH, 3, SIZE, SIZE, device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(0))
    x = x.to(next(engine.model.parameters()).dtype)
    layouts = {
        "channels_last": (engine.model,
                          x.contiguous(memory_format=torch.channels_last)),
        "nchw": (copy.deepcopy(engine.model).to(
            memory_format=torch.contiguous_format), x)}
    for name in ("channels_last", "nchw", "nchw", "channels_last"):
        model, xin = layouts[name]
        print(f"layout {name:14s} forward {forward_ms(torch, model, xin):8.3f}"
              f" ms/batch (profiler off)", flush=True)
    return 0


def report(torch, prof, wall, title, unit) -> int:
    """Print wall and device-busy time per unit, the idle share, device
    time by category and the top kernels of a profiled window of BATCHES
    units."""
    by_name: dict[str, float] = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name] = (by_name.get(evt.name, 0.0)
                                 + evt.device_time_total / 1e3)  # ms
    busy = sum(by_name.values())
    if busy == 0:
        print("FAIL: the profiler recorded no device time")
        return 1
    wall_ms = wall * 1e3
    print(f"{title}: wall {wall_ms / BATCHES:.3f} ms/{unit}, device busy "
          f"{busy / BATCHES:.3f} ms/{unit}, idle share "
          f"{max(0.0, 1 - busy / wall_ms):.3f} (profiler on)")
    cats: dict[str, float] = {}
    for name, ms in by_name.items():
        cats[category(name)] = cats.get(category(name), 0.0) + ms
    for cat, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        print(f"  {cat:40s} {ms / BATCHES:8.3f} ms/{unit} "
              f"{ms / busy:6.1%}")
    print("top kernels by device time:")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:20]:
        print(f"  {ms / BATCHES:8.3f} ms/{unit} {ms / busy:6.1%}  {name[:110]}")
    return 0


def profile_train(torch, profile, ProfilerActivity, np) -> int:
    """Training steps of yolo11l@640 bf16 at batch 16: augment_batch, then
    Trainer.train_step, under the profiler; then one step split into its
    phases by synchronised host clocks."""
    from caesar_yolo_tpu_torch.models.layers import train_mode
    from caesar_yolo_tpu_torch.models.yolo import build_model, init_weights
    from caesar_yolo_tpu_torch.train.augment import (augment_batch,
                                                     draw_augment_params)
    from caesar_yolo_tpu_torch.train.loss import detection_loss
    from caesar_yolo_tpu_torch.train.trainer import TrainConfig, Trainer

    trainer = Trainer(init_weights(build_model("yolo11l"), seed=0),
                      TrainConfig(batch_size=TRAIN_BATCH, img_size=SIZE),
                      steps_per_epoch=100)
    rng = np.random.default_rng(0)
    imgs = torch.rand(TRAIN_BATCH, SIZE, SIZE, 3, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(0))
    xy = rng.random((TRAIN_BATCH, 4, 2)) * (SIZE - 200) + 20
    boxes = torch.from_numpy(np.concatenate(
        [xy, xy + rng.uniform(40, 160, (TRAIN_BATCH, 4, 2))], -1)
        .astype(np.float32))
    masks = torch.from_numpy(np.arange(4)[None]
                             < rng.integers(1, 4, (TRAIN_BATCH, 1)))
    labels = torch.from_numpy(rng.integers(0, 5, (TRAIN_BATCH, 4)))
    gen = torch.Generator().manual_seed(0)

    def step():
        a, b, m = augment_batch(imgs, boxes, masks,
                                *draw_augment_params(gen, TRAIN_BATCH))
        trainer.train_step(a, labels, b, m)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(BATCHES):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if report(torch, prof, wall, f"train path yolo11l@{SIZE} bf16 batch "
              f"{TRAIN_BATCH} (augment_batch + train_step)", "step") != 0:
        return 1

    times: dict[str, list] = {k: [] for k in ("augment", "forward + loss",
                                             "backward", "update")}
    params = list(trainer.params.values())
    for _ in range(BATCHES):
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        a, b, m = augment_batch(imgs, boxes, masks,
                                *draw_augment_params(gen, TRAIN_BATCH))
        mark()
        x, gl, gb, mg = trainer._to_device(a, labels, b, m)
        for p in params:
            p.grad = None
        with train_mode(trainer.model):
            loss, _ = detection_loss(trainer.model(x), gl, gb, mg,
                                     img_size=SIZE)
            mark()
            loss.backward()
            mark()
        trainer._apply_update(params)
        mark()
        for k, t0, t1 in zip(times, marks, marks[1:]):
            times[k].append((t1 - t0) * 1e3)
    print("train step phases (profiler off, synchronised host clocks, mean "
          f"of {BATCHES}): " + ", ".join(
              f"{k} {np.mean(v):.1f} ms" for k, v in times.items()))
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f}"
          " GiB")
    return 0


def forward_ms(torch, model, x, iters=10):
    """Mean device time of one forward pass, by CUDA events after
    warm-up."""
    with torch.inference_mode():
        for _ in range(2):
            model(x)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            model(x)
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


if __name__ == "__main__":
    sys.exit(main())
