"""Training loop: SGD (Nesterov) with the published schedules, parameter
EMA, precise-BN and checkpoints, on one GPU or data-parallel over a
process group.

Counterpart of caesar_yolo_tpu/train/trainer.py.  The update is the
reference's optax chain written out (trainer.py:94-102), per parameter:

    g = clip_by_global_norm(raw gradients, 10)
    g = g + weight_decay * p          (conv/linear weights `w` only)
    t = g + momentum * t;  u = g + momentum * t     (Nesterov trace)
    p = p - lr * u
    ema = ema * d + p * (1 - d)

with lr and momentum evaluated on the optimizer's 0-based step count, and
EMA decay d = ema_decay * (1 - exp(-step / tau)) with the step after its
increment.  The model's parameters are the f32 master weights; the
forward runs in `compute_dtype` (bf16 by default), the loss in f32.
BatchNorm trains with batch statistics; its running statistics are
written by `calibrate_bn` (precise-BN, an f32 forward).  Checkpoints are
`torch.save` files with a `.step` sidecar.

Under a process group (parallel/mesh.py: one process per GPU) the step is
the reference's data-parallel step over one global batch (trainer.py:
121-209): each rank passes its shard; BatchNorm normalises with the global
batch's statistics (layers.global_moments) and the loss with its target-
score sum and size (train/loss.py), so the ranks' gradients sum to the
global batch's.  They are summed as one flat buffer before the clip, which
then sees the global norm as optax's does after XLA's psum.  Rank 0's
weights are broadcast at construction; from there every rank applies the
same update to the same state, so the optimizer and EMA state stay equal
without further collectives.  Rank 0 writes the checkpoints.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from caesar_yolo_tpu_torch import logger
from caesar_yolo_tpu_torch.models.layers import BatchNorm, train_mode
from caesar_yolo_tpu_torch.models.yolo import YOLO
from caesar_yolo_tpu_torch.parallel import mesh
from caesar_yolo_tpu_torch.train.loss import detection_loss
from caesar_yolo_tpu_torch.utils.device import exact_f32, resolve_device
from caesar_yolo_tpu_torch.utils.trace import NULL


@dataclass(frozen=True)
class TrainConfig:
    """Training hyper-parameters (the reference's published defaults)."""
    epochs: int = 300
    batch_size: int = 16
    img_size: int = 640
    lr0: float = 0.01
    lrf: float = 0.01
    momentum: float = 0.937
    weight_decay: float = 5e-4
    warmup_epochs: float = 3.0
    warmup_momentum: float = 0.8
    box_gain: float = 7.5
    cls_gain: float = 0.5
    dfl_gain: float = 1.5
    ema_decay: float = 0.9999
    ema_tau: float = 2000.0
    grad_clip_norm: float = 10.0
    max_gt: int = 64
    # forward dtype; master weights, gradients, optimizer state and the
    # loss stay f32.  "float32" opts out (CPU tests, debugging).
    compute_dtype: str = "bfloat16"
    # checkpoint each parameterised layer (recompute in backward)
    remat: bool = False


def make_optimizer(cfg: TrainConfig, steps_per_epoch: int):
    """(lr_fn, mom_fn) of the 0-based step count, in f32 as the
    reference evaluates them: linear warmup of lr (0 -> lr0) and momentum
    (warmup_momentum -> momentum) over the warmup epochs, then linear lr
    decay to lr0 * lrf at the last step."""
    total_steps = max(cfg.epochs * steps_per_epoch, 1)
    warmup_steps = max(int(cfg.warmup_epochs * steps_per_epoch), 1)
    f32 = np.float32

    def lr_fn(step: int) -> float:
        s = f32(step)
        frac = np.clip(s / f32(total_steps), f32(0), f32(1))
        base = f32(cfg.lr0) * ((f32(1) - frac) * f32(1.0 - cfg.lrf)
                               + f32(cfg.lrf))
        warm = f32(cfg.lr0) * np.clip(s / f32(warmup_steps), f32(0), f32(1))
        return float(warm if step < warmup_steps else base)

    def mom_fn(step: int) -> float:
        ramp = np.clip(f32(step) / f32(warmup_steps), f32(0), f32(1))
        return float(f32(cfg.warmup_momentum)
                     + f32(cfg.momentum - cfg.warmup_momentum) * ramp)

    return lr_fn, mom_fn


def ema_decay_at(cfg: TrainConfig, step: int) -> tuple[float, float]:
    """(d, 1 - d) in f32, d = decay * (1 - exp(-step / tau)) for the step
    after its increment."""
    f32 = np.float32
    d = f32(cfg.ema_decay) * (f32(1) - np.exp(f32(-step) / f32(cfg.ema_tau)))
    return float(d), float(f32(1) - d)


def _is_decayed(name: str) -> bool:
    """Weight decay applies to conv/linear weights only (not BN/bias)."""
    return name.rsplit(".", 1)[-1] == "w"


class Trainer:
    """Detection trainer on one device, or one rank of a data-parallel
    group.

    `model` holds the f32 master weights; it is moved to `device` (this
    process's GPU by default, raising without one; "cpu" for the CPU), in
    channels_last memory on CUDA."""

    def __init__(self, model: YOLO, cfg: TrainConfig, *,
                 steps_per_epoch: int = 100, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = model.float().to(self.device)
        if self.device.type == "cuda":
            self.model = self.model.to(memory_format=torch.channels_last)
        if mesh.distributed():
            with torch.no_grad():   # every rank starts from rank 0's state
                for t in self.model.state_dict().values():
                    mesh.broadcast_(t)
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        self.lr_fn, self.mom_fn = make_optimizer(cfg, steps_per_epoch)
        self.params = dict(self.model.named_parameters())
        self.decayed = [_is_decayed(n) for n in self.params]
        self.trace = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.ema = {n: t.detach().clone()
                    for n, t in self.model.state_dict().items()}
        self.step = 0
        # the span recorder of a traced run (utils/trace.py); none by default
        self.recorder = NULL
        # best validation metric seen so far, kept across resume
        self.best_metric = -1.0
        # (step, loss) of every step `fit` ran, the loss a device scalar
        self.loss_log: list = []

    # -- one step ----------------------------------------------------------

    def _to_device(self, images, gt_labels, gt_bboxes, mask_gt):
        def t(a, dtype):
            return torch.as_tensor(a).to(self.device, dtype)
        images = t(images, torch.float32)
        # [B, S, S, C] -> [B, C, S, S]: channels_last memory on CUDA
        x = images.permute(0, 3, 1, 2).to(self.compute_dtype)
        return (x, t(gt_labels, torch.int64), t(gt_bboxes, torch.float32),
                t(mask_gt, torch.bool))

    def train_step(self, images, gt_labels, gt_bboxes, mask_gt):
        """One optimizer step.  images [B, S, S, C] float32 in [0, 1];
        gt_labels [B, M] int; gt_bboxes [B, M, 4] xyxy px; mask_gt [B, M]
        bool (numpy or tensors).  Under a process group each rank passes
        its local shard of the global batch (the reference's contract,
        trainer.py:194-209).  Returns the global batch's (loss, parts) as
        device scalars."""
        cfg = self.cfg
        x, gl, gb, mg = self._to_device(images, gt_labels, gt_bboxes,
                                        mask_gt)
        params = list(self.params.values())
        for p in params:
            p.grad = None
        with train_mode(self.model):
            raw = self.model(x, remat=cfg.remat)
            loss, parts = detection_loss(
                raw, gl, gb, mg, img_size=cfg.img_size,
                box_gain=cfg.box_gain, cls_gain=cfg.cls_gain,
                dfl_gain=cfg.dfl_gain)
            loss.backward()
        self._apply_update(params)
        if mesh.distributed():      # the ranks' shares of the global loss
            loss, *vals = mesh.all_reduce_sum(torch.stack(
                [loss.detach()] + [parts[k].detach() for k in parts]))
            parts = dict(zip(parts, vals))
        return loss.detach(), {k: v.detach() for k, v in parts.items()}

    @torch.no_grad()
    def _apply_update(self, params):
        """The optax chain written out with multi-tensor (_foreach) ops:
        a handful of launches per step instead of several per tensor.
        The clip multiplies by max_norm / g_norm where optax divides by
        g_norm and then multiplies (one f32 rounding apart)."""
        cfg = self.cfg
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if mesh.distributed():
            # one collective for every gradient, then back into each
            # gradient's own layout (channels_last on CUDA)
            with self.recorder.span("train.grad_all_reduce"):
                flat = mesh.all_reduce_sum(
                    torch.cat([g.reshape(-1) for g in grads]))
                torch._foreach_copy_(grads, [
                    f.view_as(g) for f, g in zip(
                        flat.split([g.numel() for g in grads]), grads)])
        g_norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        factor = torch.where(g_norm < cfg.grad_clip_norm,
                             torch.ones_like(g_norm),
                             cfg.grad_clip_norm / g_norm)
        grads = torch._foreach_mul(grads, factor)
        decayed = [i for i, dec in enumerate(self.decayed) if dec]
        torch._foreach_add_([grads[i] for i in decayed],
                            [params[i] for i in decayed],
                            alpha=cfg.weight_decay)
        lr = self.lr_fn(self.step)
        mom = self.mom_fn(self.step)
        traces = list(self.trace.values())
        torch._foreach_mul_(traces, mom)
        torch._foreach_add_(traces, grads)            # t = g + mom * t
        updates = torch._foreach_add(grads, traces, alpha=mom)
        torch._foreach_add_(params, updates, alpha=-lr)
        self.step += 1
        d, one_minus_d = ema_decay_at(cfg, self.step)
        state = self.model.state_dict()
        ema = [self.ema[k] for k in state]
        torch._foreach_mul_(ema, d)
        torch._foreach_add_(ema, list(state.values()), alpha=one_minus_d)

    # -- loop --------------------------------------------------------------

    def fit(self, dataset, *, epochs=None, log_every: int = 50,
            checkpoint_dir: str | None = None, checkpoint_every: int = 0):
        """Run over an iterable of (images, gt_labels, gt_bboxes, mask_gt)
        batches per epoch."""
        epochs = epochs or self.cfg.epochs
        for epoch in range(epochs):
            losses = []
            for i, batch in enumerate(dataset):
                loss, parts = self.train_step(*batch)
                losses.append(loss)     # device scalars: no sync per step
                self.loss_log.append((self.step, loss))
                if log_every and i % log_every == 0:
                    logger.info(
                        "epoch %d step %d loss=%.4f box=%.3f cls=%.3f "
                        "dfl=%.3f", epoch, i, float(loss),
                        float(parts["box"]), float(parts["cls"]),
                        float(parts["dfl"]))
            logger.info("epoch %d mean loss %.4f", epoch,
                        float(torch.stack(losses).mean()) if losses
                        else float("nan"))
            if checkpoint_dir and checkpoint_every and \
                    (epoch + 1) % checkpoint_every == 0:
                self.save_checkpoint(checkpoint_dir, step=epoch + 1)
        if checkpoint_dir:
            self.save_checkpoint(checkpoint_dir, step=epochs, name="last")

    # -- BatchNorm calibration ---------------------------------------------

    @torch.no_grad()
    def calibrate_bn(self, batches) -> None:
        """Precise-BN: run `batches` (image arrays [B, S, S, C]) through
        the model in train mode, average each BatchNorm's batch mean and
        variance (in f64 on the host) and write them into the model and
        the EMA.  The forward runs in f32 whatever `compute_dtype` is, as
        the reference's does on its f32 images (its model computes in the
        input's dtype), with TF32 off on the card (`exact_f32`)."""
        names = {m: n for n, m in self.model.named_modules()
                 if isinstance(m, BatchNorm)}
        sums: dict = {}
        n = 0
        for images in batches:
            x = torch.as_tensor(images).to(self.device, torch.float32)
            x = x.permute(0, 3, 1, 2)
            stats: dict = {}
            with train_mode(self.model, stats), exact_f32():
                self.model(x)
            for bn, (mean, var) in stats.items():
                mean = mean.double().cpu().numpy()
                var = var.double().cpu().numpy()
                if bn in sums:
                    sums[bn][0] += mean
                    sums[bn][1] += var
                else:
                    sums[bn] = [mean, var]
            n += 1
        if n == 0:
            return
        for bn, (mean, var) in sums.items():
            mean = torch.from_numpy((mean / n).astype(np.float32))
            var = torch.from_numpy((var / n).astype(np.float32))
            bn.mean.copy_(mean)
            bn.var.copy_(var)
            self.ema[f"{names[bn]}.mean"].copy_(mean)
            self.ema[f"{names[bn]}.var"].copy_(var)
        logger.info("Calibrated BatchNorm stats over %d batches (%d layers)",
                    n, len(sums))

    # -- EMA weights -------------------------------------------------------

    def ema_model(self) -> YOLO:
        """A copy of the model (on the CPU, f32) holding the EMA weights."""
        import copy
        model = copy.deepcopy(self.model).cpu().float()
        model.load_state_dict({k: v.cpu() for k, v in self.ema.items()})
        return model.to(memory_format=torch.contiguous_format)

    # -- checkpoints -------------------------------------------------------

    def save_checkpoint(self, directory: str, step: int = 0,
                        name: str | None = None) -> str:
        """Write `<directory>/<name or step_N>` (torch.save of params, EMA,
        optimizer state, step and best metric) and its `.step` sidecar,
        which resume resolution ranks candidates by.  Under a process group
        rank 0 writes and every rank waits for it; all return the path."""
        path = os.path.abspath(os.path.join(directory, name or f"step_{step}"))
        if mesh.process_index() == 0:
            self._write_checkpoint(path)
        if mesh.distributed():
            mesh.barrier()
        return path

    def _write_checkpoint(self, path: str) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)

        def host(d):
            return {k: v.detach().cpu().contiguous() for k, v in d.items()}

        tmp = path + ".tmp"
        torch.save({"params": host(self.model.state_dict()),
                    "ema_params": host(self.ema),
                    "opt_state": {"trace": host(self.trace),
                                  "count": self.step},
                    "step": self.step,
                    "best_metric": float(self.best_metric)}, tmp)
        os.replace(tmp, path)
        with open(path + ".step", "w") as f:
            f.write(f"{self.step}\n")
        logger.info("Saved checkpoint %s", path)

    @staticmethod
    def load_checkpoint(path: str) -> dict:
        return torch.load(path, map_location="cpu", weights_only=True)

    def restore(self, path: str) -> int:
        """Resume from a save_checkpoint file: weights, EMA, the momentum
        trace and the step (the schedules key off it).  Returns the step."""
        ck = self.load_checkpoint(path)
        self.model.load_state_dict(ck["params"])
        for k, v in ck["ema_params"].items():
            self.ema[k].copy_(v)
        for k, v in ck["opt_state"]["trace"].items():
            self.trace[k].copy_(v)
        self.step = int(ck["step"])
        self.best_metric = float(ck.get("best_metric", -1.0))
        logger.info("Resumed from %s at step %d (best_metric=%.4f)",
                    path, self.step, self.best_metric)
        return self.step
