"""Training steps of `cli.train`'s sequence, driven from the program's own
pieces: the DetectionDataset over FITS cutouts with device letterbox, the
letterbox to the training size, `draw_augment_params` + `augment_batch`
with cli.train's defaults, and `Trainer.train_step` under TrainConfig's
defaults (SGD with Nesterov momentum, EMA, a bf16 forward).

Set-up builds one trainer and drives it through its first
`checked_steps` steps by the window's own feed and call, recording each
step's loss, the optimizer's momentum trace after the first step (the
first gradient as the optimizer gets it: clipped, with weight decay) and
the parameters' change after the last; the window then goes on with the
same trainer and feed, across epoch boundaries.

Workload parameters (workloads/<cell>.json):
  data            the traffic (traffic/synth5.py: n_images, size, ...)
  batch, max_gt, epochs   TrainConfig's (epochs sets the lr schedule)
  augment         draw_augment_params' degrees, scale, flipud, fliplr
  init            changes to the configuration's weight draw for this
                  cell (reference/weights.py)
  checked_steps   steps run in set-up and followed by the reference
  trace_units     steps the traced run's profiler session covers
  limits          {"loss_gap", "grad_gap", "update_gap"}: see check()
"""

from __future__ import annotations

import gc
import os
import time

import torch

from harness.core import log, substream
from reference import compare
from reference import train as ref_train
from reference.model import YOLO, exact_f32, load_npz
from reference.weights import calibrate, draw, save_npz
from traffic import synth5

KERNEL_COUNTERS = {
    "row_shift_kernel":
        "caesar_yolo_tpu_torch.ops.cuda_shift:"
        "fractional_row_shift_batch.row_launches",
    "col_shift_kernel":
        "caesar_yolo_tpu_torch.ops.cuda_shift:"
        "fractional_row_shift_batch.column_launches",
}


def reference_batches(ctx, n):
    """The first n batches of epoch 0 as the reference works them out
    from the written cutouts and the seeds."""
    p, size = ctx.cell.params, ctx.cell.config["imgsz"]
    order = ref_train.epoch_order(ctx.data_seed, 0, len(ctx.images))
    gen = ref_train.epoch_generator(ctx.data_seed, 0)
    out = []
    for i in range(n):
        idx = order[i * p["batch"]:(i + 1) * p["batch"]]
        x, labels, boxes, mask = ref_train.load_batch(
            ctx.images, ctx.lines, idx, size, p["max_gt"], ctx.device)
        draws = ref_train.draw_augment(gen, len(idx), **p["augment"])
        x, boxes, mask = ref_train.augment(x, boxes, mask, *draws)
        out.append((x, labels, boxes, mask))
    return out


def make_weights(ctx, path):
    """Draw the configuration's weights from the seed on the device and
    calibrate them on the first batch as the step sees it (augmented)."""
    cfg = ctx.cell.config
    init = dict(cfg["init"], **ctx.cell.params.get("init", {}))
    with exact_f32():
        model = YOLO(cfg["model"], cfg["nc"]).to(ctx.device)
        draw(model, substream(ctx.seed, 1), init, ctx.device)
        x = reference_batches(ctx, 1)[0][0]
        calibrate(model, x.permute(0, 3, 1, 2), init, train=True)
    save_npz(model, path, {"model": cfg["model"], "num_classes": cfg["nc"]})


def feed(ctx):
    """cli.train's per-step sequence, epoch after epoch: the loader's
    batch (its next() in the span data_wait), to the device, 1 -> 3
    channels, the letterbox, the epoch's augmentation draws, the
    augmentation."""
    from caesar_yolo_tpu_torch.detect.letterbox import letterbox_batch
    from caesar_yolo_tpu_torch.train.augment import (augment_batch,
                                                     draw_augment_params)
    p, size, ds = ctx.cell.params, ctx.cell.config["imgsz"], ctx.dataset
    epoch = 0
    while True:
        ds.set_epoch(epoch)
        gen = ref_train.epoch_generator(ctx.data_seed, epoch)
        batches = iter(ds)
        try:
            while True:
                with ctx.spans("data_wait"):
                    batch = next(batches, None)
                if batch is None:
                    break
                imgs, labels, boxes, masks = batch
                t = torch.from_numpy(imgs).to(ctx.device, torch.float32)
                if t.shape[-1] == 1:
                    t = t.repeat(1, 1, 1, 3)
                if t.shape[1] != size or t.shape[2] != size:
                    t = letterbox_batch(t, size)
                draws = draw_augment_params(gen, t.shape[0], **p["augment"])
                t, boxes, masks = augment_batch(
                    t, torch.from_numpy(boxes), torch.from_numpy(masks),
                    *draws)
                yield t, labels, boxes, masks
        finally:
            batches.close()
        epoch += 1


def train_step(ctx):
    with ctx.spans("step"):
        batch = next(ctx.feed)
        return ctx.trainer.train_step(*batch)[0]


def setup(ctx):
    p, cfg = ctx.cell.params, ctx.cell.config
    ctx.data_seed = substream(ctx.seed, 0)
    root = os.path.join(ctx.tmp, "data")
    with ctx.spans("setup.traffic"):
        ctx.images, ctx.lines = synth5.write_dataset(
            root, ctx.data_seed, device=ctx.device, **p["data"])
    with ctx.spans("setup.weights"):
        ctx.weights = os.path.join(ctx.tmp, "weights.npz")
        make_weights(ctx, ctx.weights)
    with ctx.spans("setup.import"):
        from caesar_yolo_tpu_torch.models.convert import (load_jax_params,
                                                          load_params)
        from caesar_yolo_tpu_torch.models.yolo import build_model
        from caesar_yolo_tpu_torch.train.dataset import DetectionDataset
        from caesar_yolo_tpu_torch.train.trainer import TrainConfig, Trainer
    model = load_jax_params(build_model(cfg["model"], num_classes=cfg["nc"]),
                            load_params(ctx.weights)[0])
    ctx.dataset = DetectionDataset(
        os.path.join(root, "dataset.yaml"), img_size=cfg["imgsz"],
        batch_size=p["batch"], max_gt=p["max_gt"], seed=ctx.data_seed,
        device_letterbox=True)
    ctx.steps_per_epoch = len(ctx.dataset)
    ctx.trainer = Trainer(model, TrainConfig(
        epochs=p["epochs"], batch_size=p["batch"], img_size=cfg["imgsz"],
        max_gt=p["max_gt"], compute_dtype=cfg["compute_dtype"]),
        steps_per_epoch=ctx.steps_per_epoch, device=ctx.device)
    ctx.feed = feed(ctx)
    if ctx.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    params = ctx.trainer.params
    start = {k: v.detach().float().cpu().clone() for k, v in params.items()}
    ctx.ours = {"loss": []}
    with ctx.spans("setup.checked_steps"):
        for i in range(p["checked_steps"]):
            ctx.ours["loss"].append(float(train_step(ctx)))
            if i == 0:
                ctx.ours["grad1"] = {k: t.detach().cpu().clone() for k, t in
                                     ctx.trainer.trace.items()}
    ctx.ours["delta"] = {k: v.detach().float().cpu() - start[k]
                         for k, v in params.items()}


def window(ctx, seconds, tracer):
    tracer.begin()
    t0 = ctx.window_t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 - tracer.overhead_s < seconds or n == 0:
        train_step(ctx)
        n += 1
        ctx.units.append({"images": ctx.cell.params["batch"]})
        tracer.after_unit()
    if ctx.device == "cuda":
        torch.cuda.synchronize()
    # the profiler's stop (the traced run only) is not the program's time
    ctx.window_s = time.perf_counter() - t0 - tracer.overhead_s


def kernel_checks(ctx):
    return dict(KERNEL_COUNTERS)


def memory_peak(ctx):
    if ctx.device != "cuda":
        return 0
    return torch.cuda.max_memory_allocated()


def attempted(ctx):
    return len(ctx.units), 0


def end_to_end(ctx):
    images = sum(u["images"] for u in ctx.units)
    return {"train_images_per_s": images / ctx.window_s}


def release(ctx):
    ctx.feed.close()
    ctx.feed = ctx.trainer = ctx.dataset = None
    gc.collect()
    if ctx.device == "cuda":
        torch.cuda.empty_cache()


def follow(ctx, quant=None):
    """The reference's first steps from the written weights; `quant`
    (the control) rounds every conv's operands."""
    cfg, p = ctx.cell.config, ctx.cell.params
    from reference.model import Conv
    with exact_f32():
        model = load_npz(YOLO(cfg["model"], cfg["nc"]), ctx.weights)
        model = model.to(ctx.device)
        batches = reference_batches(ctx, p["checked_steps"])
        Conv.quant = quant
        try:
            out = ref_train.follow(model, batches, cfg["imgsz"],
                                   ctx.steps_per_epoch, p["epochs"])
        finally:
            Conv.quant = None
    return {"loss": out["loss"],
            "grad1": {k: v.cpu() for k, v in out["grad1"].items()},
            "delta": {k: v.cpu() for k, v in out["delta"].items()}}


def head_finals(keys):
    """The leaves of the head's last convs (its box and class outputs)."""
    last = {}
    for k in keys:
        p = k.split(".")
        if p[0] == "head":
            last[p[1], p[2]] = max(last.get((p[1], p[2]), 0), int(p[3]))
    return {k for k in keys if k.startswith("head.")
            and int(k.split(".")[3]) == last[tuple(k.split(".")[1:3])]}


def fp8(t):
    """The tensor rounded to float8 e4m3 under a per-tensor scale (its
    largest magnitude to e4m3's 448), as fp8 training scales; the
    gradient passes as through the identity."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / 448.0
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t.detach())


def check(ctx):
    """[(name, value, limit)]: the worst step's relative loss gap, and by
    the worst leaf the gap between the program's and the reference's
    norms of the first gradient and of the parameters' change
    (reference/compare.py:leaf_gap).  Variant fp8: the reference with fp8
    operands stands in the program's place (the control)."""
    lim = ctx.cell.params["limits"]
    ref = follow(ctx)
    ours = follow(ctx, fp8) if ctx.variant == "fp8" else ctx.ours
    keep = compare.moving_leaves(ref["grad1"])
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(ours["loss"],
                                                        ref["loss"]))
    grad_gap, grad_leaf = compare.leaf_gap(ours["grad1"], ref["grad1"],
                                           keep)
    upd_gap, upd_leaf = compare.leaf_gap(ours["delta"], ref["delta"], keep)
    log(f"losses ours {ours['loss']} ref {ref['loss']}; worst leaves: "
        f"grad {grad_leaf}, update {upd_leaf}; {len(keep)} of "
        f"{len(ref['grad1'])} leaves compared")
    finals = head_finals(keep)
    log("diagnostics:", {
        "loss1_gap": abs(ours["loss"][0] - ref["loss"][0]) / abs(
            ref["loss"][0]),
        "grad_head_final_gap": compare.leaf_gap(ours["grad1"], ref["grad1"],
                                                finals)[0],
        "update_head_final_gap": compare.leaf_gap(ours["delta"],
                                                  ref["delta"], finals)[0],
        "grad_median_gap": compare.median_gap(ours["grad1"], ref["grad1"],
                                              keep),
        "update_median_gap": compare.median_gap(ours["delta"], ref["delta"],
                                                keep)})
    return [("loss_gap", loss_gap, lim["loss_gap"]),
            ("grad_gap", grad_gap, lim["grad_gap"]),
            ("update_gap", upd_gap, lim["update_gap"])]
