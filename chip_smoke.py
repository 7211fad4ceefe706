#!/usr/bin/env python3
"""Quickest proof that the PyTorch port builds and runs on one NVIDIA H100.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero before the last line):
  build     the hand-written kernels (csrc/*.cu, one nvcc per source, all
            started together)
  parity    each kernel against its plain PyTorch version on the card, at
            the main paths' shapes (K1 at K = 512 and 2048; K2 at yolo11l's
            N = 400 and the mosaic tiles' N = 256; K2's backward and K4 at
            the training path's, K4's backward on the concat's channel
            slice, at an offset not 16-byte aligned, at a C not a multiple
            of 8 (no copy) and on an NCHW gradient (one copy); K3 at the
            main path's tiles and the eval cutouts on its cluster route and
            at [2, 2048, 2048] on its stream route, with all-zero, NaN,
            constant and all-masked-but-one planes; K5 at the mosaic's
            tiles, a truncated
            group, the serial crop and the eval cutouts on its cluster
            route and at [2, 2048, 2048] on its stream route, and on the
            two pinned inputs where it once failed its rule
            (scripts/torch_k5_kept_probe.py); K6 at the
            mosaic's tiles, the serial crop, the eval cutouts and two odd
            shapes on its cluster route and at [2, 1024, 1024] on its
            stream route, with NaN, +-inf, constant and all-but-one planes;
            K8 on its row and column routes at the training canvas, at a
            row of W*C not a multiple of 4 and at C = 1, on random shifts
            and shears; route counters checked; K5 and K7 with zero, NaN
            and constant planes; K7 on both routes at the eval path's
            cutout planes, the tile size and two odd shapes; K3, K4, K6, K7
            and K8 bit-equal)
  yolo12    K2 at yolo12l's area-attention shapes, forward and backward,
            and yolo12l's tile step replayed as a CUDA graph
  golden    yolov8n_synth96 at 96 px in f32 (TF32 off) against the JAX
            engine's committed outputs (tests/fixtures/
            torch_port_golden_v8n96.npz), by the catalog rule
  golden-eval
            the port's evaluate_dataset in f32 (TF32 off), raw and with the
            CLAHE Pipeline (K7), against the JAX evaluate_dataset's outputs
            (tests/fixtures/torch_port_golden_eval_v8n96.npz), by
            tests/test_torch_eval_golden.golden_mismatch
  golden-mosaic
            the port's SFinder.run_tiled in f32 (TF32 off) on the committed
            mosaic against the JAX SFinder's catalogs in the tile context
            (tests/fixtures/torch_port_golden_mosaic_v8n96.npz) and in the
            global context on the device-resident path (..._global_v8n96
            .npz), by the catalog rule with equal edge and merged flags
  main      yolo11l at 640 px in bf16 with seeded weights: TileEngine on
            batches of 32 synthetic tiles (one all-zero), then
            Analyzer.predict writing a JSON catalog and a DS9 file; K1-K4
            must have launched on this path, and K10 once a conv; staged
            tiles/s
  epilogue  K10 (csrc/epilogue.cu, the bf16 conv epilogue) bit-equal to
            its plain version on every bf16 conv of one yolo11l forward
            (batch 32), each call on its own input
  export    the serving artifacts (deploy.py, torch.export): yolo11l@640
            bf16, batch 32, README chain, exported, saved and loaded in a
            fresh process that imports deploy.py alone (no model code, no
            JAX), equal to the live TileEngine bit for bit on the main
            phase's batches, with K1, K2, K3, K4 and K10 launched inside
            it; an --int8 artifact equal to the live int8 engine (K9); a
            bkg + chan3 + min-max artifact on 512 px tiles equal to the live
            engine (K5, K6); cli.serve on the first in a subprocess:
            /healthz, raw and .npy /detect equal to each other and to the
            artifact, latency; export and load seconds, artifact MB (by
            part), staged tiles/s of the artifact against the live engine
            and the ops each dispatches a batch, a call's host cost direct
            and through its op, and one 32-window read by the native FITS
            reader against the memory-map slices
  mosaic    the CLI (cli.run) on a seeded 2560x2560 FITS mosaic with a
            NaN-blanked border, yolo11l@640 bf16, tiled (100 tiles of 512
            px at step 0.5, four shapes, batches of 32; bkg + chan3 +
            min-max) once per device-tiling mode: off (streamed windows),
            auto (must take the whole mosaic), banded (the cap at one
            band's bytes), global context (the chain once on the whole
            plane: K5 and K6, or K3 with the README chain, counted on their
            stream routes); tiles/s, path, host->device bytes, reads, puts,
            drain and phase times of each; the three tile-context catalogs
            must agree by the catalog rule; then a serial run on a 640x640
            crop; each writes a JSON catalog and a DS9 file, and K1, K2, K5
            and K6 must have launched as often as the stages imply
  multiproc the port's torch.distributed runs, each rank a subprocess
            (tests/torch_mp_worker.py): the mosaic's tiled cli.run on two
            gloo ranks sharing the card (the launcher's environment,
            --devices=cuda:0), on one process, and on one NCCL rank: 50 +
            50 tiles, each rank's K1, K2, K5 and K6 launches as its batches
            imply, the same catalog on both ranks, one catalog and one DS9
            file (rank 0's) and no spool, the catalog equal to the one
            process's by the catalog rule with equal edge and merged flags;
            walls, tiles/s and the gather's rounds and bytes.  Trainer steps
            of yolo11l@640 in f32 (TF32 off) on a seeded global batch of 16,
            augmented once: two gloo ranks of 8 (equal weights and EMA
            across ranks, held to the one process on 16 by the golden-train
            rule with each update norm's f32 resolution (train_mismatch);
            K2-bwd, K4-bwd and K8 in each rank), and one NCCL rank; then
            bf16 steps: step time, collectives a step, the gradient
            all-reduce's time and share (and its span under
            torch.profiler); last, the golden batch on two gloo ranks
            against the JAX Trainer's numbers by the golden-train rule
  profile   one auto tiled run with --profile_dir: a non-empty trace, the
            device's busy share
  resume    scripts/torch_drill_banded_resume.py at the mosaic's size:
            banded runs as subprocesses, one SIGKILLed once its spool holds
            a grid row of tiles, then resumed; the catalog must be the
            uninterrupted run's, bit for bit
  pt        the main phase's seeded yolo11l written as an ultralytics
            checkpoint ({"model", "ema", "epoch"}, ultralytics' keys, its
            classes in a module gone at load time): cli.convert's npz must
            hold save_params' leaves bit for bit, and cli.run serially on
            the mosaic's 640x640 crop (README chain, bf16) must write the
            same catalog from the .pt as from the npz, launching K1, K2 and
            K3; the .pt load-and-convert time beside the npz load time
  weights   npz weights to the engine's model in one pass (models/
            convert.py: read_npz, build_prepared) for yolo11l, yolov8l and
            yolo12l at 5 classes, weights seeded and written as the
            benchmark writes them: bit-equal to prepare_model's copy of
            load_model's model in every parameter (dtype, shape, strides);
            then a 2560 px field of yolo11l through cli.run and through
            the copy route (load_model_from_args, an SFinder that copies),
            in turns: the set-up spans of each (cli.load_weights,
            cli.build, cli.preprocessor, sfinder.header, engine.prepare;
            weights.read, weights.upload, weights.fold), the last three
            on the direct route alone
  image     the crop as an 8-bit RGB PNG and a 16-bit grey PNG (this
            script's stdlib encoder): read_image must give the written
            values / 255 or / 65535 exactly, and cli.run on each must write
            Analyzer.predict's catalog on the same array; cli.evaluate on 32
            labelled 132 px PNG cutouts (README chain, K3 once a batch),
            images/s; JPEG through Pillow where it imports, else refused
            with the error that names it
  synth5    64 five-class cutouts (utils/synth5.py) rendered on the card
            against the plain CPU render of the same draws (labels and
            masks equal, images within 1e-5, boxes within 1e-4 px); then
            the trained tests/fixtures/torch_quality5_v8n.npz (yolov8n)
            in bf16 at 640 px on 512 held-out cutouts: the quality gate
            (macro-F1 > 0.5, every class's F1 > 0.2) and its table
  golden-bf16
            the port's bf16 Predictor at 640 px with the trained model on
            16 cutouts against the JAX package's bf16 outputs
            (tests/fixtures/torch_port_golden_bf16_q5.npz), by ROADMAP's
            whole bf16 rule (tests/test_torch_golden_bf16.bf16_mismatch:
            detections partnered both ways, each stride's mean class
            logit within 4e-3)
  int8      K9 (csrc/qconv.cu, the int8 conv) bit-equal to its plain version
            on the shapes of QCONV_SHAPES and, by forward hooks, on every
            dense conv of yolo11l at 640 px, batch 32; cli.run --int8
            serially on the mosaic's 640x640 crop with yolo11l (calibrated
            on three crops of the mosaic; K1-K4 and K9 counted); the
            trained five-class model in int8 on the 512 held-out cutouts:
            the quality gate, the macro-F1 drop from bf16, and the cutouts
            on which the JAX quality test's per-image rule (same count,
            IoU >= 0.85, same classes, scores within 0.1) holds against
            bf16, beside the same count for f32 against bf16;
            TileEngine staged tiles/s of yolo11l@640 batch 32, bf16 and
            int8 in turns; K9's timing row (the whole call, its
            quantize pass and its GEMM)
  golden-train
            2 f32 steps (TF32 off) of the port's Trainer on the committed
            batch from yolov8n_synth96 against the JAX Trainer's numbers
            (tests/fixtures/torch_port_golden_train_v8n96.npz), by
            tests/test_torch_train_golden.golden_mismatch
  eval      96 seeded FITS cutouts of 132 px with YOLO labels (3 batches of
            32), yolo11l@640 bf16 with seeded weights: cli.evaluate with the
            README preprocessing (K3), evaluate_dataset from Python with
            Pipeline([hist_equalizer(adaptive=True)]) (K7, one cluster
            launch a batch), and cli.run --datalist (batched route,
            out_<stem>.json/.reg per image); each must launch its kernels
            once per batch; images/s
  train     the training CLI (cli.train) on yolo11l@640 bf16, batch 16, on
            a seeded set of 48 FITS cutouts of 132 px, validating on 32
            held-out cutouts after every epoch: 2 epochs of 3 steps,
            precise-BN over an augmented epoch, the `best` and `last`
            checkpoints and the npz export (loaded into a TileEngine for
            one batch), then a --resume from step_2 that runs a third epoch
            and keeps the best metric; K1, K2, K2-backward, K4 (forward and
            backward) and K8 must have launched as often as the steps and
            validations imply, and K4's backward must have read every
            gradient where it lies (no copy); step time, images/s and
            validation time; precise-BN from the trained weights under a
            bf16 TrainConfig bit-equal to a float32 config's (both forward
            in f32, as the reference's), and for 2 images at most a
            quarter as far from the CPU's statistics as a TF32 forward
  upsample-ab
            main-path and mosaic tiles/s with K4 and with the plain
            broadcast upsample, in turns (plain, K4, K4, plain)
  shear-ab  augment_batch ms at the training batch with the y-shear as a
            transposed copy and a row launch and on K8's column route, in
            turns (transpose, column, column, transpose); the same bits
  planes    K3, K5 (three sigma pairs) and K6 on whole-mosaic planes
            [1, 2560, 2560], [1, 16384, 16384] and [1, 32769, 32768]
            (2^30 + 32768 values, 4 GiB, past 32-bit indices) on their
            stream routes (counted) against their plain versions (K3, K6
            bit-equal, K5 by its rule), timed beside their bounds, each
            plane freed before the next (a `whole_plane` line; the 2560 px
            rows join the `kernels` line)
  timing    each kernel, its plain version and (where one exists) the
            PyTorch library call, by CUDA events (K1, K2, K2's backward,
            K3, K5, K6, K8 and K9 also by device time under torch.profiler,
            K9 beside torch._int_mm on its unfolded input and cuDNN's bf16
            conv of the same shape, K1,
            K2's backward, K3, K4's backward, K6 and K8 per launch, K10 at
            the main path's most launched epilogue shape, K2 at
            both N, K3 also at the eval cutouts, K7's whole call at the
            eval cutouts and the tile size beside the stream route's
            histogram and blend launches, K5 and K6 also at the
            serial crop, K6 on both routes, K8 on both routes and as the
            transposed copy the column route replaces, K4's backward at the
            concat's slice with its time on a contiguous gradient and the
            channels_last copy of the slice beside it, and K2's backward's
            peak memory beyond its inputs and outputs); tiles/s of the main
            path

Prints the card's name and power limit (and beside every timing line), a
`kernels` JSON line, and as the last line {"ok": true, "device": {...}}.
Needs one card; never imports JAX or the JAX package.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from collections import Counter
from contextlib import nullcontext

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
# the device of the synth5, golden-bf16 and int8 phases
DEVICE = "cuda"
MAIN_BATCH = 32
MAIN_BATCHES = 3
MAIN_SIZE = 640
PRE_NMS = 512

# H100 SXM peaks (NVIDIA data sheet, dense) for the bound of each kernel
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
# device_ms queues its calls behind a spin of QUEUE_SPIN_CYCLES GPU cycles
# (at least QUEUE_SPIN_S at the H100's 1980 MHz) and kernel_split opens
# each profiler session with PROFILE_PRIME launches of a 1000-cycle spin:
# torch.profiler drops the first records of a session, one more about
# every 13 s of the process's life, whatever the kernels' lengths
# (scripts/torch_profiler_clock.py; PERF.md §6)
QUEUE_SPIN_CYCLES, QUEUE_SPIN_S = 200_000_000, 0.1
PROFILE_PRIME = 256
PROFILE_SESSIONS = 3

# tolerances of the parity phase (bf16 attention: cuda_attn.bf16_mismatch,
# at most BF16_ATOL and a changed share of at most BF16_MAX_CHANGED_SHARE;
# clip statistics: cuda_stats.stats_mismatch, medians exact; zscale +
# min-max and histogram equalisation: bit-equal)
ATTN_F32_TOL = 1e-5
# K2 backward in f32: within 1e-5 of each gradient's largest value; in bf16
# by cuda_attn.bwd_bf16_mismatch.  K4 and K8: bit-equal.
ATTN_BWD_F32_REL_TOL = 1e-5

# the training phase: yolo11l@640 bf16 at the reference's batch 16 on 48
# cutouts of 132 px (the reference's cutout size): 3 steps an epoch
TRAIN_BATCH = 16
TRAIN_IMAGES = 48
TRAIN_CUTOUT = 132
TRAIN_EPOCHS = 2
TRAIN_TIMED_STEPS = 5
# the augmentation canvas at 640 px: 640 + 2 * (int(0.35 * 640) + 2), and
# the row shift's pad (augment._rot_scale_sample_batch)
SHIFT_CANVAS = 1092
SHIFT_PAD = SHIFT_CANVAS // 2 + 2
# K8's parity shapes: the training canvas, a row of W*C floats that is not a
# multiple of 4, and one channel
SHIFT_SHAPES = (((TRAIN_BATCH, SHIFT_CANVAS, SHIFT_CANVAS, 3), SHIFT_PAD),
                ((2, 30, 21, 3), 12), ((2, 30, 21, 1), 12))
# augment_batch calls timed in each turn of the y-shear A/B
AB_AUGMENTS = 10
# yolo11l's two neck upsamples at 640 px: [B, 512, 20, 20] and [B, 512, 40, 40]
NECK_SHAPES = ((512, 20, 20), (512, 40, 40))

# the mosaic phase: 2560 px at 512 px tiles and step 0.5 is a 10x10 grid
# whose last row and column are 256 px wide: 81 + 9 + 9 + 1 tiles in four
# shapes, 3 + 1 + 1 + 1 = 6 batches of 32
MOSAIC_SIZE = 2560
MOSAIC_TILE = 512
# K2's sequence lengths: yolo11l's C2PSA at 640 px (20 x 20) and at the
# mosaic's 512 px tiles (16 x 16)
ATTN_NS = ((MAIN_SIZE // 32) ** 2, (MOSAIC_TILE // 32) ** 2)
MOSAIC_SIGMAS = ((3.0, 3.0), (0.0, 20.0), (1.0, 20.0))  # bkg, chan3 clips
# K5's parity shapes: the mosaic's tiles and a truncated group, the serial
# crop, the eval cutouts (cluster route), and a plane too large for a
# cluster's shared memory (stream route)
K5_SHAPES = ((MAIN_BATCH, MOSAIC_TILE, MOSAIC_TILE),
             (MAIN_BATCH, MOSAIC_TILE // 2, MOSAIC_TILE),
             (1, MAIN_SIZE, MAIN_SIZE),
             (MAIN_BATCH, TRAIN_CUTOUT, TRAIN_CUTOUT),
             (2, 2048, 2048))
# K3's parity shapes: the main path's tiles, the eval cutouts (cluster
# route) and planes past the cluster route's limit (stream route; two edge
# planes and a noise plane)
PREPROC_SHAPES = ((MAIN_BATCH, MAIN_SIZE, MAIN_SIZE),
                  (MAIN_BATCH, TRAIN_CUTOUT, TRAIN_CUTOUT), (3, 2048, 2048))
# K6's parity shapes: the mosaic's tiles, the serial crop, the eval
# cutouts, two odd shapes (cluster route) and planes past the cluster
# route's limit (stream route)
HISTEQ_SHAPES = ((MAIN_BATCH, MOSAIC_TILE, MOSAIC_TILE),
                 (1, MAIN_SIZE, MAIN_SIZE),
                 (MAIN_BATCH, TRAIN_CUTOUT, TRAIN_CUTOUT), (6, 96, 100),
                 (5, 33, 47), (2, 1024, 1024))
# per batch (or serial image): one K5 launch for the background, one for
# each chan3 clip; one K6 launch for chan3's third channel; one NMS; two
# C2PSA attentions in yolo11l
PER_FORWARD = {"stats": 3, "histeq": 1, "nms": 1, "attn": 2, "upsample": 2}
# kernels only the training path launches
TRAIN_ONLY = ("attn_bwd", "upsample_bwd", "shift")
# K7, which only a CLAHE stage reaches
CLAHE = ("clahe",)
# the eval phase: 96 cutouts of 132 px, 3 batches of 32; the training
# phase validates on 32 more, in batches of min(16, 32)
EVAL_IMAGES = 96
VAL_IMAGES = 32
# K7's parity shapes: the eval path's cutout planes, the tile size, an odd
# shape that reflect-pads one axis and one whose rows are not a multiple of
# 16 bytes, padded on both; and a plane past the cluster route (stream)
CLAHE_SHAPES = ((MAIN_BATCH, TRAIN_CUTOUT, TRAIN_CUTOUT),
                (MAIN_BATCH, MAIN_SIZE, MAIN_SIZE), (4, 96, 100), (5, 33, 47))
CLAHE_STREAM_SHAPE = (3, 1024, 1024)
# K5's pinned inputs (scripts/torch_k5_kept_probe.py): the parity phase's
# planes when its K3 check draws every shape and edge case, and seed 127
K5_PINNED = ("k3-shapes-edges", 127)
# the random model's class scores sit at its head's bias priors (~2.5e-3
# at stride 32): at 3e-3 its catalog is empty, at 1e-3 each tile keeps one
# detection after NMS and the merge, so the catalog has 100 sources and
# edge flags plus stitch take milliseconds
# (scripts/torch_mosaic_thresholds.py)
MOSAIC_SCORE_THR = 1e-3
# the mosaic phase's preprocessing (bkg + chan3 + min-max), the README chain
# and the tiled flags: 512 px tiles at step 0.5, batches of 32
MOSAIC_CHAIN = ["--preprocessing", "--subtract_bkg", "--chan3_preproc",
                "--sigma_clip_baseline=0", "--sigma_clip_low=1",
                "--sigma_clip_up=20", "--normalize_minmax", "--norm_min=0",
                "--norm_max=255"]
README_CHAIN = ["--preprocessing", "--zscale_stretch", "--normalize_minmax"]
MOSAIC_TILED = ["--split_img_in_tiles", f"--tile_xsize={MOSAIC_TILE}",
                f"--tile_ysize={MOSAIC_TILE}", "--tile_xstep=0.5",
                "--tile_ystep=0.5", "--max_ntasks_per_worker=1000",
                f"--batch_size={MAIN_BATCH}"]
# the mosaic phase's tiled runs: the chain, more flags, and the path the
# run must take ("band": the cap at one band's bytes; "global": the chain
# run once on the whole mosaic, K5 and K6, or K3 for the README chain, on
# their stream routes)
MOSAIC_MODES = {
    "off": (MOSAIC_CHAIN, ["--device_tiling=off"], "stream"),
    "auto": (MOSAIC_CHAIN, [], "full"),
    "band": (MOSAIC_CHAIN, [], "band"),
    "global": (MOSAIC_CHAIN, ["--preproc_context=global"], "full"),
    "global-readme": (README_CHAIN, ["--preproc_context=global"], "full"),
}
# whole-mosaic planes: the mosaic's plane, a survey field's, and one past 2^30 values (4 GiB in
# f32; the stream routes' 64-bit indices)
WHOLE_PLANES = ((1, MOSAIC_SIZE, MOSAIC_SIZE), (1, 16384, 16384),
                (1, 32769, 32768))
# the multiproc phase: each rank a subprocess of tests/torch_mp_worker.py
# with its own timeout; two gloo ranks share the card (NCCL refuses two
# ranks on one device), then one process, then one NCCL rank.  Training:
# yolo11l@640 f32 (TF32 off) on a seeded global batch of MP_TRAIN_BATCH
# (half a rank), augmented once, MP_TRAIN_STEPS steps, then one bf16 step
# timed and one profiled
MP_TIMEOUT_S = 420
MP_TRAIN_BATCH = 16
MP_TRAIN_STEPS = 2
MP_AUGMENT_SEED = 5
# the synth5 phase: cutouts rendered on the card against the CPU (rules of
# tests/test_torch_synth5.py), the trained five-class model and its
# held-out evaluation
SYNTH5_PARITY = 64
SYNTH5_IMG_TOL, SYNTH5_BOX_TOL = 1e-5, 1e-4
QUALITY5_NPZ = os.path.join("tests", "fixtures", "torch_quality5_v8n.npz")
QUALITY5_EVAL = 512
# the JAX quality test's int8 rules (tests/test_quant.py): IoU >= 0.85, the
# same classes, scores within 0.1, per image
INT8_IOU, INT8_SCORE_TOL = 0.85, 0.1
# the trained model in int8 against its bf16 on the held-out cutouts: its
# macro-F1 at most INT8_MF1_DROP below, and the per-image rule holding on
# at least INT8_RULE_HELD of them.  Set from this script's readings on the
# H100 (PERF.md §6): the sound int8 model -0.0005 and 476; the control,
# every int8 conv's xs times INT8_CONTROL_XS, 0.0378 and 427, must miss
INT8_MF1_DROP = 0.02
INT8_RULE_HELD = 450
INT8_CONTROL_XS = 1.25
# K9's parity shapes: the stem (cin 3, 3x3 stride 2), 3x3 stride 1 and 2,
# 1x1, odd cout and cin not multiples of 16 or 32, batch 1 to 32, bf16 and
# f32, in the layouts the model hands over (channels_last, a channel slice
# of it, NCHW): (b, cin, cout, h, w, k, stride, dtype, layout)
QCONV_SHAPES = (
    (2, 3, 16, 24, 24, 3, 2, "bfloat16", "channels_last"),
    (1, 3, 64, 17, 19, 3, 2, "float32", "nchw"),
    (3, 32, 48, 12, 12, 3, 1, "bfloat16", "channels_last"),
    (2, 64, 64, 10, 9, 3, 2, "float32", "channels_last"),
    (4, 40, 72, 8, 8, 1, 1, "bfloat16", "slice"),
    (2, 13, 37, 11, 7, 3, 1, "float32", "slice"),
    (1, 19, 5, 9, 10, 1, 1, "bfloat16", "nchw"),
    (32, 24, 20, 6, 6, 3, 1, "bfloat16", "channels_last"),
    (32, 17, 131, 4, 4, 3, 2, "float32", "channels_last"),
)


def log(*args):
    print(*args, flush=True)


CARD = ""        # nvidia-smi's name and power limit, set by main()


def on_card(text):
    """A measured line with the card it was measured on."""
    return f"{text} [{CARD}]"


class Failed(Exception):
    pass


def require(cond, what):
    if not cond:
        raise Failed(what)


def time_ms(torch, fn, iters=20, warmup=3):
    """Mean device time of fn() in ms, by CUDA events after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters=20):
    """Device time of fn() in ms a call: CUDA events around iters calls
    queued behind a spin of QUEUE_SPIN_CYCLES, so the card runs them back
    to back (no host launch gap; the card's own gap between launches, about
    a microsecond, stays in).  A host that takes longer than the spin to
    queue the calls fails the run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_SPIN_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    require(host < QUEUE_SPIN_S, f"device_ms: the host took {host:.3f} s "
            f"to queue {iters} calls, longer than the spin")
    return start.elapsed_time(end) / iters


def kernel_name(name):
    """A kernel's name without its return type, namespaces, template
    arguments and argument list ("void (anonymous namespace)::k<1>(...)"
    -> "k")."""
    short = name.replace("(anonymous namespace)::", "").split("(")[0]
    short = short.split("<")[0].removeprefix("void ").split("::")[-1]
    return short.strip() or name


def kernel_split(torch, fn, iters=20):
    """{kernel name: device ms a call} of fn(): device_ms shared among the
    kernels it launches (launches of one name summed) by their time under
    torch.profiler, in a session opened by PROFILE_PRIME spins, left out.
    A session that keeps no kernel record of fn (torch.profiler can drop
    a session's first records) is opened again, up to PROFILE_SESSIONS
    times."""
    from torch.profiler import ProfilerActivity, profile
    total = device_ms(torch, fn, iters)
    for _ in range(PROFILE_SESSIONS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_PRIME):
                torch.cuda._sleep(1000)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        split = Counter()
        for e in prof.events():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and "spin_kernel" not in e.name):
                split[kernel_name(e.name)] += e.device_time_total
        kept = sum(split.values())
        if kept > 0:
            return {name: round(total * t / kept, 5)
                    for name, t in split.items()}
    raise Failed(f"kernel_split: the profiler kept no kernel record in "
                 f"{PROFILE_SESSIONS} sessions")


def bound_ms(nbytes, flops, dtype):
    """Least time the card could take: the larger of bytes over the memory
    rate and operations over the peak rate for their type."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def synthetic_detections(rng, b, a, spread, tied):
    """Decoded-looking boxes [B, A, 4] and class scores [B, A, 5]."""
    cx = rng.random((b, a)) * spread
    cy = rng.random((b, a)) * spread
    wh = rng.random((b, a, 2)) * 40 + 4
    boxes = np.stack([cx - wh[..., 0] / 2, cy - wh[..., 1] / 2,
                      cx + wh[..., 0] / 2, cy + wh[..., 1] / 2],
                     axis=-1).astype(np.float32)
    scores = (rng.random((b, a, 5)) ** 8).astype(np.float32)
    if tied:
        scores = np.round(scores * 16) / 16
    return boxes, scores


def online_softmax_attention(q, k, v, scale):
    """What K2 must not do, in plain PyTorch: round p before normalising
    (the deferred normalisation of an online softmax)."""
    import torch
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = torch.matmul(p.to(v.dtype).float(), v.float())
    return (out / p.sum(dim=-1, keepdim=True)).to(v.dtype)


def phase_parity(torch):
    """Kernel vs plain version on the card.  Returns the per-kernel
    comparison errors and the timing inputs."""
    from caesar_yolo_tpu_torch.detect import cuda_nms, nms
    from caesar_yolo_tpu_torch.models import cuda_attn
    from caesar_yolo_tpu_torch.ops import cuda_preproc
    from caesar_yolo_tpu_torch.ops.zscale import zscale_limits

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    errs, inputs = {}, {}
    anchors = sum((MAIN_SIZE // s) ** 2 for s in (8, 16, 32))

    # K1: masks bit-equal on random, tied-score and crowded candidates
    mismatches = 0
    for k in (PRE_NMS, 2048):
        for case, spread in (("random", 640.0), ("tied", 640.0),
                             ("crowded", 120.0)):
            boxes, scores = synthetic_detections(
                rng, MAIN_BATCH, anchors, spread, tied=case == "tied")
            sel = nms._select_candidates(
                torch.from_numpy(boxes).to(dev),
                torch.from_numpy(scores).to(dev), 0.25 if case != "crowded"
                else 0.01, k, False)
            top_valid, n_dropped, nms_boxes = sel[3], sel[4], sel[5]
            if case == "crowded":
                require(bool((n_dropped > 0).all()),
                        "crowded NMS case did not overflow pre_nms")
            got = cuda_nms.nms_suppress(nms_boxes.transpose(1, 2),
                                        top_valid, 0.5)
            torch.cuda.synchronize()
            ref = cuda_nms.suppress_plain(nms_boxes, top_valid, 0.5)
            bad = int((got != ref).sum())
            mismatches += bad
            log(f"parity K1 nms K={k} {case}: kept {int(got.sum())}, "
                f"mismatched bits {bad}")
            if k == PRE_NMS and case == "random":
                inputs["nms"] = (nms_boxes.transpose(1, 2).contiguous(),
                                 top_valid)
    require(mismatches == 0, f"NMS kernel mask differs ({mismatches} bits)")
    errs["nms"] = float(mismatches)

    # K2: C2PSA attention of yolo11l at 640 px (N = 400) and at the mosaic's
    # 512 px tiles (N = 256)
    g = torch.Generator(device=dev).manual_seed(0)
    b, h, kd, hd = MAIN_BATCH, 4, 32, 64
    for n in ATTN_NS:
        q, k_, v = (torch.randn(b, h, n, d, device=dev, generator=g)
                    for d in (kd, kd, hd))
        scale = kd ** -0.5
        args = (q, k_, v, scale)
        got = cuda_attn.attention(*args)
        torch.cuda.synchronize()
        err = (got - cuda_attn.attention_plain(*args)).abs().max().item()
        log(f"parity K2 attention f32 N={n}: max abs err {err:.3g} "
            f"(tolerance {ATTN_F32_TOL})")
        require(err <= ATTN_F32_TOL, f"attention kernel f32 N={n} err {err}")
        args = (q.bfloat16(), k_.bfloat16(), v.bfloat16(), scale)
        got = cuda_attn.attention(*args)
        torch.cuda.synchronize()
        ref = cuda_attn.attention_plain(*args)
        diff = (got.float() - ref.float()).abs()
        err = diff.max().item()
        why = cuda_attn.bf16_mismatch(got, ref)
        log(f"parity K2 attention bf16 N={n}: max abs err {err:.3g}, changed "
            f"share {(diff > 0).float().mean().item():.3g} (limits "
            f"{cuda_attn.BF16_ATOL}, {cuda_attn.BF16_MAX_CHANGED_SHARE}; "
            f"max |out| {ref.float().abs().max().item():.3g})")
        require(why is None, f"attention kernel bf16 N={n}: {why}")
        # the rule can see a kernel that rounds p before normalising
        online = online_softmax_attention(*args)
        why_online = cuda_attn.bf16_mismatch(online, ref)
        log(f"parity K2 rule on an online softmax N={n} (plain PyTorch): "
            f"{why_online}")
        require(why_online is not None, "bf16 rule passes an online softmax")
        errs["attn"] = max(errs.get("attn", 0.0), err)
        inputs[f"attn{n}"] = args

    # K3 on both routes with the edge planes, bit-equal, the route counted:
    # the main path's tiles take one draw of rng (the later checks' planes
    # follow it), the other shapes their own generator
    bad = 0
    own = np.random.default_rng(3)
    for shape in PREPROC_SHAPES:
        route = cuda_preproc.plan(shape[1] * shape[2])[0]
        x = preproc_planes(dev, rng if shape == PREPROC_SHAPES[0] else own,
                           shape)
        vmin, vmax = zscale_limits(x)
        vlims = torch.stack([vmin, vmax], dim=1)
        counter = f"{route}_launches"
        before = getattr(cuda_preproc.zscale_minmax, counter)
        out, zl = cuda_preproc.zscale_minmax(x, vlims)
        torch.cuda.synchronize()
        ran = getattr(cuda_preproc.zscale_minmax, counter) == before + 1
        ref, rzl = cuda_preproc.zscale_minmax_plain(x, vlims)
        valid = torch.isfinite(zl[:, 0]) & (zl[:, 1] > zl[:, 0])
        same = torch.equal(out, ref) and torch.equal(zl, rzl)
        err = (out - ref).abs().max().item()
        log(f"parity K3 zscale+minmax {tuple(shape)} ({route} route, counted "
            f"{ran}): max abs err {err:.3g} (tolerance 0), bit-equal {same}, "
            f"invalid planes {(~valid).nonzero().flatten().tolist()}")
        bad += not (ran and same and not bool(valid[0] | valid[1])
                    and bool(valid[-1]))
        if shape == PREPROC_SHAPES[0]:
            inputs["preproc"] = (x, vlims)
    require(bad == 0, "zscale+minmax kernel differs (the all-zero and NaN "
            "planes must be invalid, the last noise plane valid)")
    errs["preproc"] = 0.0

    # K5 at the paths' shapes, on both routes, with edge-case planes; K6 at
    # the mosaic phase's batch shape
    from caesar_yolo_tpu_torch.ops import cuda_histeq, cuda_stats
    from caesar_yolo_tpu_torch.ops.histeq import equalize_hist
    err = 0.0
    for shape in K5_SHAPES:
        route, cluster, _ = cuda_stats.plan(shape[1] * shape[2])
        for planes in k5_planes(dev, rng, shape):
            for sig in (MOSAIC_SIGMAS if shape == K5_SHAPES[0]
                        else MOSAIC_SIGMAS[::2]):
                err = max(err, parity_stats(torch, planes, sig, route,
                                            cluster))
    # the pinned inputs, each from its own generator (rng is not advanced)
    probe = script("torch_k5_kept_probe")
    for pinned in K5_PINNED:
        planes = mosaic_planes(dev, probe.parity_generator(pinned)
                               if isinstance(pinned, str)
                               else np.random.default_rng(pinned))
        route, cluster, _ = cuda_stats.plan(planes[0].numel())
        log(f"parity K5 on the pinned input {pinned!r}:")
        for sig in MOSAIC_SIGMAS:
            err = max(err, parity_stats(torch, planes, sig, route, cluster))
    errs["stats"] = err
    x = mosaic_planes(dev, rng)
    inputs["stats"] = x
    bad = 0
    for shape in HISTEQ_SHAPES:
        route = cuda_histeq.plan(shape[1] * shape[2])[0]
        planes = x if shape == HISTEQ_SHAPES[0] else histeq_planes(dev, rng,
                                                                   shape)
        counter = f"{route}_launches"
        before = getattr(cuda_histeq.equalize_hist_batch, counter)
        got = cuda_histeq.equalize_hist_batch(planes)
        torch.cuda.synchronize()
        ran = getattr(cuda_histeq.equalize_hist_batch, counter) == before + 1
        ref = equalize_hist(planes)
        err = (got.nan_to_num() - ref.nan_to_num()).abs().max().item()
        same_nan = torch.equal(got.isnan(), ref.isnan())
        log(f"parity K6 hist-eq {tuple(planes.shape)} ({route} route, "
            f"counted {ran}): max abs err {err:.3g} (tolerance 0), NaN "
            f"planes equal {same_nan}")
        bad += not (ran and err == 0 and same_nan)
    require(bad == 0, "hist-eq kernel differs")
    errs["histeq"] = 0.0
    inputs["histeq"] = x
    parity_train_kernels(torch, dev, errs, inputs)
    parity_clahe(torch, dev, errs, inputs)
    return errs, inputs


# yolo12l at 640 px, batch 32: K2 over P4's 4 strips of 400 positions and
# over P5's 400, 8 heads of 32 (q, k and v alike); the backward at a
# training batch of 16
AREA_SHAPES = ((128, 8, 400, 32), (32, 8, 400, 32))
AREA_BWD_SHAPE = (16, 8, 400, 32)
AREA_PER_FORWARD = 16   # yolo12l: 8 ABlocks at P4, 8 at P5


def phase_yolo12(torch):
    """YOLO12's area attention on the card: K2's bf16 parity and time at
    yolo12l's two shapes (cuda_attn.bf16_mismatch) and its backward at the
    training shape (bwd_bf16_mismatch); then yolo12l's tile step through
    the engine on three README batches: the second captured, the third
    replayed, no fallback, AREA_PER_FORWARD K2 launches a forward, counted
    as fused by the area-attention counter, the replay included."""
    from caesar_yolo_tpu_torch.models import cuda_attn, layers
    from caesar_yolo_tpu_torch.models.yolo import build_model, init_weights
    from caesar_yolo_tpu_torch.ops.transforms import build_preprocessor
    from caesar_yolo_tpu_torch.parallel.engine import TileEngine
    from caesar_yolo_tpu_torch.utils.trace import Recorder

    dev = torch.device("cuda")
    for shape in AREA_SHAPES:
        g = torch.Generator(device=dev).manual_seed(shape[0])
        q, k, v = (torch.randn(*shape, device=dev, generator=g).bfloat16()
                   for _ in range(3))
        scale = shape[3] ** -0.5
        got = cuda_attn.attention(q, k, v, scale)
        torch.cuda.synchronize()
        why = cuda_attn.bf16_mismatch(
            got, cuda_attn.attention_plain(q, k, v, scale))
        require(why is None, f"K2 at {list(shape)}: {why}")
        ms = time_ms(torch, lambda: cuda_attn.attention(q, k, v, scale))
        dms = device_ms(torch, lambda: cuda_attn.attention(q, k, v, scale))
        b, h, n, d = shape
        bound = bound_ms(4 * b * h * n * d * 2, 2 * b * h * n * n * 2 * d,
                         "bfloat16")
        plain = time_ms(torch, lambda: cuda_attn.attention_plain(
            q, k, v, scale), iters=5)
        log(on_card(f"yolo12 K2 {list(shape)} bf16: parity ok, "
                    f"{ms:.5f} ms (device {dms:.5f}), bound {bound[0]:.5f} "
                    f"ms ({bound[1]}), plain {plain:.4f} ms"))
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v, dout = (torch.randn(*AREA_BWD_SHAPE, device=dev, generator=g)
                     .bfloat16() for _ in range(4))
    scale = AREA_BWD_SHAPE[3] ** -0.5
    got = cuda_attn.attention_backward(q, k, v, dout, scale)
    torch.cuda.synchronize()
    why = cuda_attn.bwd_bf16_mismatch(
        got, cuda_attn.attention_backward_plain(q, k, v, dout, scale))
    require(why is None, f"K2 backward at {list(AREA_BWD_SHAPE)}: {why}")
    ms = time_ms(torch, lambda: cuda_attn.attention_backward(
        q, k, v, dout, scale), iters=10)
    log(on_card(f"yolo12 K2 backward {list(AREA_BWD_SHAPE)} bf16: parity "
                f"ok, {ms:.5f} ms"))

    engine = TileEngine(init_weights(build_model("yolo12l"), seed=0),
                        preprocessor=build_preprocessor(
                            zscale_stretch=True, normalize_minmax=True),
                        img_size=MAIN_SIZE, score_thr=0.7)
    engine.recorder = Recorder()
    rng = np.random.default_rng(12)
    tiles = rng.random((MAIN_BATCH, 512, 512, 1), dtype=np.float32)
    k2, fused = cuda_attn.attention.launches, layers.area_attention.fused
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        engine.process(tiles)
        walls.append(time.perf_counter() - t0)
    c = engine.recorder.counters
    require(c.get("engine.graph_fallbacks", 0) == 0
            and c.get("engine.graph_captures") == 1
            and c.get("engine.graph_replays") == 2,
            f"yolo12l's tile step did not replay: {c}")
    require(cuda_attn.attention.launches - k2 == 3 * AREA_PER_FORWARD
            and layers.area_attention.fused - fused == 3 * AREA_PER_FORWARD,
            f"yolo12l: {cuda_attn.attention.launches - k2} K2 launches, "
            f"{layers.area_attention.fused - fused} fused area-attention "
            f"calls over 3 forwards")
    log(on_card(f"yolo12l tile step [32,512,512] at 640 px: eager, captured, "
                f"replayed in {', '.join(f'{w:.4f}' for w in walls)} s; "
                f"{AREA_PER_FORWARD} K2 launches a forward, counters {c}"))


def histeq_planes(dev, rng, shape):
    """Noise planes with K6's edge cases where the plane count allows: a
    NaN (it poisons its plane), +inf, -inf, a constant plane, all values
    equal but one, a bright source."""
    import torch
    p, h, w = shape
    x = rng.normal(0, 1, shape).astype(np.float32)
    cases = [lambda a: a.__setitem__((h // 2, 3), np.nan),
             lambda a: a.__setitem__((1, 1), np.inf),
             lambda a: a.__setitem__((2, 2), -np.inf),
             lambda a: a.fill(7.0),
             lambda a: (a.fill(2.0), a.__setitem__((h - 1, w - 1), 5.0)),
             lambda a: a.__setitem__((slice(h // 3, h // 3 + 6),
                                      slice(w // 2, w // 2 + 6)), 300.0)]
    for i, case in enumerate(cases[:p] if p > 1 else []):
        case(x[i])
    return torch.from_numpy(x).to(dev)


def preproc_planes(dev, rng, shape, offset=0):
    """Noise planes [P, H, W] with K3's edge cases on the planes before the
    last, as many as there are: all zero, a NaN (on a pixel zscale
    samples, so the limits are NaN), a constant plane, all masked but one
    pixel, a masked square, +inf, 2% of the pixels over 60 decades, planes
    at 1e-17 and 1e25 (operands past the fast division's range); the last
    plane stays noise.  Takes one draw of rng; the edge cases draw from
    their own generator.  The planes start `offset` floats into their
    storage (offset 1: not 16-byte aligned)."""
    import torch
    p, h, w = shape
    x = rng.normal(0, 1, shape).astype(np.float32)
    own = np.random.default_rng(h * w)
    cases = [lambda a: a.fill(0.0),
             lambda a: a.__setitem__((0, 0), np.nan),
             lambda a: a.fill(7.0),
             lambda a: (a.fill(0.0), a.__setitem__((h // 2, w // 3), 2.5)),
             lambda a: a.__setitem__((slice(h // 6, h // 3),
                                      slice(w // 6, w // 3)), 0.0),
             lambda a: a.__setitem__((h - 1, 1), np.inf),
             lambda a: a.__setitem__(  # 2% of the pixels over 60 decades
                 np.unravel_index(own.choice(a.size, a.size // 50), a.shape),
                 own.choice([-1.0, 1.0], a.size // 50)
                 * 10.0 ** own.uniform(-30, 30, a.size // 50)),
             lambda a: a.__imul__(1e-17), lambda a: a.__imul__(1e25)]
    for i, case in enumerate(cases[:p - 1]):
        case(x[i])
    flat = torch.empty(offset + x.size, device=dev)
    flat[offset:] = torch.from_numpy(x.reshape(-1)).to(dev)
    return flat[offset:].view(shape)


def shift_case(dev, g_, shape, pad, way, kind):
    """K8's inputs: imgs [B, H, W, C] (contiguous for the row route, the
    transposed view of a contiguous [B, W, H, C] canvas for the column
    route) and shifts [B, H], random past the clip or the augmentation's
    shears tan(r) * (y - centre), |r| <= 45 degrees; the clip limits on
    the first rows."""
    import torch
    b, h, w, c = shape
    if way == "row":
        imgs = torch.rand(shape, device=dev, generator=g_)
    else:
        imgs = torch.rand(b, w, h, c, device=dev, generator=g_).transpose(1, 2)
    if kind == "random":
        shifts = (torch.rand(b, h, device=dev, generator=g_) * 2 - 1) * (
            pad + 2)
    else:
        r = (torch.rand(b, device=dev, generator=g_) * 2 - 1) * (np.pi / 4)
        ys = torch.arange(h, dtype=torch.float32, device=dev) - (h - 1) / 2
        shifts = torch.tan(r)[:, None] * ys[None]
    shifts[0, :3] = torch.tensor([0.0, -pad, pad - 1.0])
    return imgs, shifts


def clahe_planes(dev, p, h, w, seed, edge_cases):
    """Noise planes with a bright source each; with edge_cases, plane 0 all
    zero, plane 1 holding a NaN and plane 2 constant."""
    import torch
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (p, h, w)).astype(np.float32)
    x[:, h // 3:h // 3 + 6, w // 2:w // 2 + 6] += 150.0
    if edge_cases:
        x[0] = 0.0
        x[1, h // 2, 3] = np.nan
        x[2] = 7.0
    return torch.from_numpy(x).to(dev)


def parity_clahe(torch, dev, errs, inputs):
    """K7 against the plain version, bit for bit, at CLAHE_SHAPES and clip
    limits 0.03 and 0.01 on both routes, each forced (the stream route's
    histogram and blend launches also one at a time), and at
    CLAHE_STREAM_SHAPE on the route its size picks; each route's counter
    must show it ran; every output finite in [0, 1]."""
    from caesar_yolo_tpu_torch.ops import clahe, cuda_clahe

    fn = cuda_clahe.equalize_adapthist_batch
    bad, err = 0, 0.0
    for p, h, w in CLAHE_SHAPES + (CLAHE_STREAM_SHAPE,):
        x = clahe_planes(dev, p, h, w, seed=h + w, edge_cases=True)
        plan = cuda_clahe.plan(h, w)
        routes = ((("cluster", plan[1:]), ("stream", (0, 0, 0)))
                  if (p, h, w) != CLAHE_STREAM_SHAPE else ((plan[0], None),))
        vmin, span = clahe.value_range(x)
        th, tw = clahe.tile_size(h, w)
        hist = cuda_clahe.tile_histograms(x, vmin, span)
        torch.cuda.synchronize()
        hist_ok = (torch.equal(hist, clahe.tile_histograms_plain(x, vmin, span))
                   and bool((hist.sum(dim=-1) == th * tw).all()))
        for clip_limit in (0.03, 0.01):
            ref = clahe.equalize_adapthist_plain(x, clip_limit)
            cdf = clahe.cdf_tables(hist, th * tw, clip_limit)
            got = cuda_clahe.blend(x, vmin, span, cdf)
            torch.cuda.synchronize()
            e = (got - clahe.blend_plain(x, vmin, span, cdf)).abs().max()
            e = e.item()
            ran, in_range = True, True
            for route, config in routes:
                before = getattr(fn, f"{route}_launches")
                out = (fn(x, clip_limit) if config is None else
                       cuda_clahe.launch(x, clip_limit, clahe.GRID, route,
                                         *config))
                torch.cuda.synchronize()
                ran &= getattr(fn, f"{route}_launches") == before + 1
                e = max(e, (out - ref).abs().max().item())
                in_range &= (bool(torch.isfinite(out).all())
                             and out.min().item() >= 0.0
                             and out.max().item() <= 1.0)
            log(f"parity K7 CLAHE {(p, h, w)} clip {clip_limit} "
                f"({' and '.join(r for r, _ in routes)} route, counted "
                f"{ran}): stream histograms equal {hist_ok}, max abs err "
                f"{e:.3g} (tolerance 0), finite in [0, 1] {in_range}")
            bad += (not hist_ok) + (e != 0) + (not in_range) + (not ran)
            err = max(err, e)
    require(bad == 0, "CLAHE kernel differs from the plain version")
    errs["clahe"] = err
    # timing inputs: the eval path's planes, cutouts with sources
    inputs["clahe"] = clahe_planes(dev, *CLAHE_SHAPES[0], seed=1,
                                   edge_cases=False)


def parity_train_kernels(torch, dev, errs, inputs):
    """K2's backward, K4 and K8 at the training path's shapes."""
    from caesar_yolo_tpu_torch.models import cuda_attn
    from caesar_yolo_tpu_torch.ops import cuda_shift, cuda_upsample

    g_ = torch.Generator(device=dev).manual_seed(1)
    b, h, n, kd, hd = TRAIN_BATCH, 4, 400, 32, 64
    q, k, v, g = (torch.randn(b, h, n, d, device=dev, generator=g_)
                  for d in (kd, kd, hd, hd))
    scale = kd ** -0.5
    got = cuda_attn.attention_backward(q, k, v, g, scale)
    torch.cuda.synchronize()
    ref = cuda_attn.attention_backward_plain(q, k, v, g, scale)
    err = max(((x - r).abs().max() / r.abs().max()).item()
              for x, r in zip(got, ref))
    log(f"parity K2-bwd attention f32 {tuple(q.shape)}/{tuple(v.shape)}: "
        f"max abs err {err:.3g} of each gradient's largest value "
        f"(tolerance {ATTN_BWD_F32_REL_TOL})")
    require(err <= ATTN_BWD_F32_REL_TOL, f"attention backward f32 err {err}")
    args = tuple(t.bfloat16() for t in (q, k, v, g))
    got = cuda_attn.attention_backward(*args, scale)
    torch.cuda.synchronize()
    ref = cuda_attn.attention_backward_plain(*args, scale)
    why = cuda_attn.bwd_bf16_mismatch(got, ref)
    diffs = [(x.float() - r.float()).abs() for x, r in zip(got, ref)]
    log("parity K2-bwd attention bf16: " + ", ".join(
        f"{name} max abs err {d.max().item():.3g} (max |ref| "
        f"{r.float().abs().max().item():.3g}), changed share "
        f"{(d > 0).float().mean().item():.3g}"
        for name, d, r in zip(("dq", "dk", "dv"), diffs, ref))
        + f" (rule cuda_attn.bwd_bf16_mismatch: 2^-8 of max |ref|, share "
        f"{cuda_attn.BWD_BF16_MAX_CHANGED_SHARE}) -> {why or 'ok'}")
    require(why is None, f"attention backward bf16: {why}")
    errs["attn_bwd"] = max(d.max().item() for d in diffs)
    inputs["attn_bwd"] = (*args, scale)

    # K4 forward; its backward on the path's input (the first C channels of
    # the concat's channels_last gradient), at an offset that is not 16-byte
    # aligned, at a C that is not a multiple of 8 (each read where it lies,
    # no copy) and on an NCHW gradient (one copy): all bit-equal
    bad = 0
    for c, hh, ww in NECK_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(TRAIN_BATCH, c, hh, ww, device=dev,
                            generator=g_).to(dtype).contiguous(
                                memory_format=torch.channels_last)
            full = torch.randn(TRAIN_BATCH, 2 * c, 2 * hh, 2 * ww, device=dev,
                               generator=g_).to(dtype).contiguous(
                                   memory_format=torch.channels_last)
            y = cuda_upsample.upsample2x_forward(x)
            torch.cuda.synchronize()
            ok = (torch.equal(y, cuda_upsample.upsample2x_plain(x))
                  and y.is_contiguous(memory_format=torch.channels_last))
            log(f"parity K4 upsample {tuple(x.shape)} {dtype}: forward "
                f"bit-equal {ok}")
            bad += not ok
            for case, gy, copies in (
                    ("the concat's slice", full[:, :c], 0),
                    ("offset 3", full[:, 3:3 + c], 0),
                    (f"C = {c - 2}", full[:, :c - 2], 0),
                    ("NCHW", full[:, :c].contiguous(), 1)):
                before = cuda_upsample.upsample2x_backward.copies
                gx = cuda_upsample.upsample2x_backward(gy)
                torch.cuda.synchronize()
                copied = cuda_upsample.upsample2x_backward.copies - before
                vb = cuda_upsample.backward_plan(
                    gy.shape, gy.stride(), gy.storage_offset(),
                    gy.element_size()) if case != "NCHW" else None
                ok = (torch.equal(
                    gx, cuda_upsample.upsample2x_backward_plain(gy))
                    and copied == copies)
                log(f"parity K4 upsample backward {tuple(gy.shape)} {dtype} "
                    f"{case} (strides {gy.stride()}, vectors {vb} bytes): "
                    f"bit-equal {ok}, copies {copied} (expected {copies})")
                bad += not ok
            if dtype == torch.bfloat16 and (c, hh, ww) == NECK_SHAPES[-1]:
                inputs["upsample"] = (x, full[:, :c])
    require(bad == 0, "upsample kernels differ from the plain versions")
    errs["upsample"] = errs["upsample_bwd"] = 0.0

    # K8 on both routes, random shifts and shears; each route's counter
    # must show it ran, and the output keeps the input's strides
    bad = 0
    for shape, pad in SHIFT_SHAPES:
        for way in ("row", "column"):
            for kind in ("random", "shear"):
                imgs, shifts = shift_case(dev, g_, shape, pad, way, kind)
                for pad_val in (114.0 / 255.0, 0.0):
                    counter = f"{way}_launches"
                    before = getattr(cuda_shift.fractional_row_shift_batch,
                                     counter)
                    got = cuda_shift.fractional_row_shift_batch(
                        imgs, shifts, pad, pad_val)
                    torch.cuda.synchronize()
                    ran = getattr(cuda_shift.fractional_row_shift_batch,
                                  counter) == before + 1
                    ref = cuda_shift.row_shift_plain(imgs, shifts, pad,
                                                     pad_val)
                    err = (got - ref).abs().max().item()
                    ok = (ran and err == 0 and torch.equal(got, ref)
                          and got.stride() == imgs.stride())
                    log(f"parity K8 row shift {tuple(imgs.shape)} pad {pad} "
                        f"{way} route ({kind} shifts, counted {ran}) pad_val "
                        f"{pad_val:.4f}: max abs err {err:.3g} (tolerance "
                        f"0), strides kept {got.stride() == imgs.stride()}")
                    bad += not ok
                if shape == SHIFT_SHAPES[0][0] and kind == "shear":
                    inputs[f"shift_{way}"] = (imgs, shifts)
                del imgs, shifts, got, ref
    require(bad == 0, "row shift kernel differs")
    errs["shift"] = 0.0


def qconv_case(torch, shape, dev, seed):
    """K9's inputs for a QCONV_SHAPES entry on `dev`, drawn on the CPU from
    `seed`: x in the entry's layout, wq int8 in channels_last memory
    ([cout][k][k][cin], as prepare_model lays it out), ws, xs (a little
    under max|x| / 127, so some inputs clip) and b."""
    b, cin, cout, h, w, k, _, dtype, layout = shape
    g = torch.Generator().manual_seed(seed)
    dtype = getattr(torch, dtype)
    if layout == "slice":        # a channel slice of a channels_last tensor
        x = (torch.randn((b, 2 * cin + 3, h, w), generator=g) * 1.7).to(
            dev, dtype).contiguous(memory_format=torch.channels_last)
        x = x[:, cin + 3:]
    else:
        x = (torch.randn((b, cin, h, w), generator=g) * 1.7).to(dev, dtype)
        if layout == "channels_last":
            x = x.contiguous(memory_format=torch.channels_last)
    wq = torch.randint(-127, 128, (cout, cin, k, k), generator=g,
                       dtype=torch.int8).to(dev).contiguous(
                           memory_format=torch.channels_last)
    ws = (torch.rand(cout, generator=g) * 0.02 + 1e-4).to(dev)
    bias = torch.randn(cout, generator=g).to(dev)
    xs = (x.float().abs().amax() / 127.0 * 0.9).reshape(())
    return x, wq, ws, xs, bias


def phase_synth5(torch):
    """Five-class cutouts rendered on the card against the plain CPU render
    of the same draws, then the trained five-class model in bf16 on the
    held-out cutouts (the quality gate).  Returns (the model, its
    macro-F1 and merged detections)."""
    from caesar_yolo_tpu_torch.models.convert import load_model
    from caesar_yolo_tpu_torch.utils.synth5 import (CLASS_NAMES,
                                                    draw_multiclass_params,
                                                    render_multiclass)
    q5 = script("torch_train_quality5")
    draws = draw_multiclass_params(
        torch.Generator().manual_seed(q5.HELDOUT_SEED0), SYNTH5_PARITY)
    ref = render_multiclass(draws)
    dev_draws = {k: v.to(DEVICE) for k, v in draws.items()}
    got = [t.cpu() for t in render_multiclass(dev_draws)]
    render_ms = time_ms(torch, lambda: render_multiclass(dev_draws), iters=10)
    img_err = float((got[0] - ref[0]).abs().max())
    box_err = float((got[2] - ref[2]).abs().max())
    same = torch.equal(got[1], ref[1]) and torch.equal(got[3], ref[3])
    log(f"synth5: {SYNTH5_PARITY} cutouts rendered on the card in "
        f"{render_ms:.3f} ms against the CPU render of the same draws: "
        f"labels and masks equal {same}, images max abs err {img_err:.3g} "
        f"(limit {SYNTH5_IMG_TOL}), boxes {box_err:.3g} px (limit "
        f"{SYNTH5_BOX_TOL})")
    require(same and img_err <= SYNTH5_IMG_TOL and box_err <= SYNTH5_BOX_TOL,
            "synth5: the card's render differs from the CPU's")

    model, meta = load_model(os.path.join(REPO, QUALITY5_NPZ))
    t0 = time.perf_counter()
    mf1, pl, table = q5_heldout(q5, model)
    wall = time.perf_counter() - t0
    log(f"synth5: {QUALITY5_NPZ} ({meta.get('steps')} steps, trained "
        f"macro-F1 {meta.get('macro_f1')}) on {QUALITY5_EVAL} held-out "
        f"cutouts at {MAIN_SIZE} px, bf16: macro-F1 {mf1:.4f}, "
        f"{QUALITY5_EVAL / wall:.1f} cutouts/s")
    for name in (*CLASS_NAMES, "source_cumulative"):
        log(f"  {name}: {table[name]}")
    require(q5.passes_gate(table, CLASS_NAMES),
            "synth5: the trained model is below the quality gate")
    return model, (mf1, pl)


def q5_heldout(q5, model, **kw):
    """One five-class model's held-out evaluation at 640 px (Predictor
    keywords `kw`; bf16 by default) -> (macro-F1, merged detections per
    cutout, class table)."""
    from caesar_yolo_tpu_torch.detect.predictor import Predictor
    from caesar_yolo_tpu_torch.utils.synth5 import CLASS_NAMES
    pred = Predictor(model, img_size=MAIN_SIZE, score_thr=q5.EVAL_SCORE_THR,
                     iou_thr=0.5, **kw)
    rep, _, pl = q5.evaluate_predictor(pred, QUALITY5_EVAL,
                                       q5.HELDOUT_SEED0, DEVICE)
    table = q5.class_table(rep, CLASS_NAMES)
    return q5.macro_f1(table, CLASS_NAMES), pl, table


def phase_golden_bf16(torch):
    """The port's bf16 Predictor at 640 px on the card against the JAX
    package's bf16 outputs on 16 five-class cutouts with the trained model
    (tests/test_torch_golden_bf16.py writes them and holds ROADMAP's bf16
    rule)."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import test_torch_golden_bf16 as golden_bf16

    golden = golden_bf16.load_golden()
    got = golden_bf16.port_outputs(golden["images"], DEVICE)
    why = golden_bf16.bf16_mismatch(golden, got)
    gaps = golden_bf16.logit_gaps(golden, got)
    log(f"golden-bf16: {int(got['valid'].sum())} detections on "
        f"{len(golden['images'])} cutouts at 640 px against the JAX bf16 "
        f"fixture's {int(golden['valid'].sum())}: stride mean class logits "
        f"{np.round(got['cls_mean'], 5).tolist()} vs "
        f"{np.round(golden['cls_mean'], 5).tolist()}, gaps "
        f"{np.round(gaps, 5).tolist()} (rule {golden_bf16.LOGIT_MEAN_TOL}); "
        f"the bf16 rule, both parts: {why or 'ok'}")
    require(why is None, f"golden-bf16: {why}")
    return gaps


def quality_rule_failure(a, b):
    """The JAX quality test's per-image rule (tests/test_quant.py:
    test_quantized_detection_quality) on two merged detection sets
    ({"bboxes", "scores", "labels"}): the same count, every box of a with
    a box of b at IoU >= 0.85, the same classes, the sorted scores within
    0.1.  Returns the first part that fails, or None."""
    from caesar_yolo_tpu_torch.utils.boxes import iou_matrix_np
    if len(a["scores"]) != len(b["scores"]):
        return "count"
    if not len(a["scores"]):
        return None
    iou = iou_matrix_np(np.asarray(a["bboxes"], float).reshape(-1, 4),
                        np.asarray(b["bboxes"], float).reshape(-1, 4))
    if not (iou.max(axis=1) >= INT8_IOU).all():
        return "iou"
    if sorted(a["labels"]) != sorted(b["labels"]):
        return "class"
    if np.abs(np.sort(a["scores"]) - np.sort(b["scores"])).max() \
            >= INT8_SCORE_TOL:
        return "score"
    return None


def rule_failures(ref, got):
    """{part: cutouts} of quality_rule_failure over paired cutouts."""
    return dict(Counter(filter(None, (quality_rule_failure(a, b)
                                      for a, b in zip(ref, got)))))


def int8_miss(bf16, got):
    """The int8-against-bf16 limits on two held-out evaluations (macro-F1,
    detections) -> (what `got` misses of them or None, the cutouts on which
    the per-image rule held, its failing parts)."""
    fails = rule_failures(bf16[1], got[1])
    held = QUALITY5_EVAL - sum(fails.values())
    drop = bf16[0] - got[0]
    why = ([f"macro-F1 {drop:.4f} below bf16's (limit {INT8_MF1_DROP})"]
           if drop > INT8_MF1_DROP else [])
    if held < INT8_RULE_HELD:
        why.append(f"the per-image rule held on {held}/{QUALITY5_EVAL} "
                   f"cutouts (limit {INT8_RULE_HELD})")
    return "; ".join(why) or None, held, fails


def qconv_parity(torch, cuda_qconv):
    """K9 against qconv_plain on QCONV_SHAPES (both activations); returns
    the largest abs error (bit-equal: 0)."""
    err = 0.0
    for i, shape in enumerate(QCONV_SHAPES):
        x, wq, ws, xs, b = qconv_case(torch, shape, DEVICE, i)
        for act in (True, False):
            got = cuda_qconv.qconv(x, wq, ws, xs, b, shape[6], shape[5] // 2,
                                   act)
            ref = cuda_qconv.qconv_plain(x, wq, ws, xs, b, shape[6],
                                         shape[5] // 2, act)
            e = float((got.float() - ref.float()).abs().max())
            log(f"parity K9 qconv {shape} act={act}: bit-equal "
                f"{torch.equal(got, ref)}, max abs err {e:.3g}")
            require(torch.equal(got, ref), f"K9 differs at {shape}")
            err = max(err, e)
    return err


def qconv_model_parity(torch, cuda_qconv, qmodel, x):
    """Every int8 conv of one forward of the prepared int8 model on x,
    held to qconv_plain on its own input (bit-equal) by forward hooks.
    Returns ({(cin, cout, h, w, k, stride): count}, max abs err)."""
    from caesar_yolo_tpu_torch.models.layers import Conv
    shapes, errs = Counter(), [0.0]

    def check(m, args, out):
        xin = args[0]
        ref = cuda_qconv.qconv_plain(xin, m.wq, m.ws, m.xs, m.b, m.s, m.pad,
                                     m.act)
        key = (m.cin, m.cout, xin.shape[2], xin.shape[3], m.k, m.s)
        require(torch.equal(out, ref), f"K9 differs in yolo11l at {key}")
        errs[0] = max(errs[0], float((out.float() - ref.float()).abs().max()))
        shapes[key] += 1

    hooks = [m.register_forward_hook(check) for m in qmodel.modules()
             if isinstance(m, Conv) and m.wq is not None]
    try:
        with torch.inference_mode():
            qmodel(x)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    return shapes, errs[0]


def qconv_timing(torch, cuda_qconv, key, err,
                 what="yolo11l's most launched 3x3 shape at 640 px"):
    """K9's row of the kernels line at one yolo11l shape (batch 32, bf16):
    CUDA events and device time, the plain version, the bound (bytes, and
    int8 ops at the dense peak), torch._int_mm on the unfolded int8 input
    (the same integer product) as the library time, and cuDNN's bf16 conv
    of the shape beside it."""
    import torch.nn.functional as F
    cin, cout, h, w, k, stride = key
    g = torch.Generator().manual_seed(9)
    x = (torch.randn((MAIN_BATCH, cin, h, w), generator=g)).to(
        DEVICE, torch.bfloat16).contiguous(memory_format=torch.channels_last)
    wq = torch.randint(-127, 128, (cout, cin, k, k), generator=g,
                       dtype=torch.int8).to(DEVICE).contiguous(
                           memory_format=torch.channels_last)
    ws = (torch.rand(cout, generator=g) * 0.01 + 1e-4).to(DEVICE)
    b = torch.randn(cout, generator=g).to(DEVICE)
    xs = (x.float().abs().amax() / 127.0).reshape(())
    pad = k // 2
    wp = cuda_qconv.pack_weights(wq)
    kernel = lambda: cuda_qconv.qconv(x, wq, ws, xs, b, stride, pad, True,
                                      wp)
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    m, kk = MAIN_BATCH * ho * wo, k * k * cin
    nbytes = x.numel() * 2 + wq.numel() + m * cout * 2 + 8 * cout + 4
    row = dict(ms=time_ms(torch, kernel, iters=100, warmup=10),
               plain_ms=time_ms(torch, lambda: cuda_qconv.qconv_plain(
                   x, wq, ws, xs, b, stride, pad, True), iters=5),
               bound=bound_ms(nbytes, 2 * m * cout * kk, "int8"))
    split = kernel_split(torch, kernel)
    again = time_ms(torch, kernel, iters=100, warmup=10)
    xq8 = cuda_qconv.quantize_padded(x, xs)
    quant_ms = time_ms(torch, lambda: cuda_qconv.quantize_padded(x, xs),
                       iters=100, warmup=10)
    gemm = lambda: cuda_qconv.qgemm(xq8, wp, ws, xs, b, stride, pad, True,
                                    x.dtype)
    gemm_ms = time_ms(torch, gemm, iters=100, warmup=10)
    gemm_dev = device_ms(torch, gemm, iters=100)
    xq = cuda_qconv.quantize_input(x, xs)
    a = F.unfold(xq, k, padding=pad, stride=stride).transpose(1, 2).reshape(
        m, kk).to(torch.int8).contiguous()
    # F.unfold orders K as (c, r, s): the weights [K, N] in that order
    bt = wq.permute(1, 2, 3, 0).reshape(kk, cout).contiguous()
    row["library_ms"] = time_ms(torch, lambda: torch._int_mm(a, bt))
    wb = torch.randn((cout, cin, k, k), generator=g).to(
        DEVICE, torch.bfloat16).contiguous(memory_format=torch.channels_last)
    cudnn_ms = time_ms(torch, lambda: F.conv2d(x, wb, None, stride, pad))
    log(on_card(
        f"timing K9 qconv [{MAIN_BATCH},{cin},{h},{w}] bf16 -> {cout} ch, "
        f"{k}x{k} stride {stride} ({what}; M={m} N={cout} K={kk}; tile "
        f"{cuda_qconv.plan(h, w, cin, cout, k, stride)}): whole call "
        f"{row['ms']:.5f} ms (after the profiler {again:.5f}; device "
        f"{sum(split.values()):.5f}: {split}); quantize pass "
        f"{quant_ms:.5f} ms, GEMM {gemm_ms:.5f} ms (device {gemm_dev:.5f}); "
        f"plain {row['plain_ms']:.5f}, bound {row['bound'][0]:.6f} "
        f"({row['bound'][1]}); torch._int_mm on the unfolded int8 input "
        f"{row['library_ms']:.5f} ms; cuDNN's bf16 conv of the shape "
        f"{cudnn_ms:.5f} ms"))
    row.update(cudnn_bf16_ms=cudnn_ms, quantize_ms=quant_ms, gemm_ms=gemm_ms)
    row["max_abs_err"] = err
    return row


def phase_int8(torch, counters, tmp, q5_model, q5_bf16):
    """int8 PTQ on the card: K9 bit-equal to its plain version on
    QCONV_SHAPES and on every dense conv of yolo11l at 640 px, batch 32
    (forward hooks on real activations); cli.run --int8 serially on the
    mosaic's 640x640 crop with yolo11l (K1-K4 and K9 counted); the trained
    five-class model in int8 on the held-out cutouts (the quality gate and
    the limits against bf16, which a control must miss); TileEngine staged
    tiles/s of yolo11l at 640 px, batch 32, int8 and bf16 in turns; K9's
    timing row.  `q5_bf16` is the trained model's bf16 (macro-F1,
    detections).  Returns (the row, K9's launches on the CLI path)."""
    from caesar_yolo_tpu_torch.detect.predictor import prepare_model
    from caesar_yolo_tpu_torch.models import cuda_qconv, quant
    from caesar_yolo_tpu_torch.models.layers import Conv
    from caesar_yolo_tpu_torch.models.yolo import build_model, init_weights
    from caesar_yolo_tpu_torch.ops.transforms import build_preprocessor
    from caesar_yolo_tpu_torch.parallel.engine import TileEngine
    from caesar_yolo_tpu_torch.utils.synth5 import (CLASS_NAMES,
                                                    make_multiclass_batch)
    q5 = script("torch_train_quality5")

    err = qconv_parity(torch, cuda_qconv)
    # yolo11l, calibrated on the main path's tiles with the README chain
    pre = build_preprocessor(zscale_stretch=True, normalize_minmax=True)
    model = init_weights(build_model("yolo11l"), seed=0)
    tiles = make_main_tiles(MAIN_BATCH)
    calib = quant.calibration_inputs_from_tiles(tiles[:4], preprocessor=pre,
                                                img_size=MAIN_SIZE)
    qmodel = quant.quantize_model(model, calib)
    n_int8 = sum(isinstance(m, Conv) and m.wq is not None
                 for m in qmodel.modules())
    x = quant.calibration_inputs_from_tiles(
        np.concatenate([tiles[:MAIN_BATCH // 2], tiles[MAIN_BATCH // 2 + 1:],
                        tiles[:1]]), preprocessor=pre, img_size=MAIN_SIZE)[0]
    shapes, e = qconv_model_parity(
        torch, cuda_qconv, prepare_model(qmodel, dtype=torch.bfloat16,
                                         device=torch.device(DEVICE)), x)
    err = max(err, e)
    log(f"parity K9 on yolo11l@{MAIN_SIZE} batch {MAIN_BATCH}: {n_int8} "
        f"int8 convs of {len(shapes)} shapes, every one bit-equal to "
        f"qconv_plain on its own input: {dict(shapes)}")
    require(sum(shapes.values()) == n_int8, "K9 parity missed a conv")
    top = max((kv for kv in shapes.items() if kv[0][4] == 3),
              key=lambda kv: (kv[1], kv[0][0] * kv[0][2] * kv[0][3]))[0]

    # cli.run --int8 on the crop: the calibration (3 crops of the whole
    # mosaic, one batch: K3 once, one bf16 forward: K2 twice, K4 twice),
    # then one int8 forward
    flags = [f"--image={os.path.join(tmp, 'mosaic.fits')}", "--xmin=0",
             "--xmax=639", "--ymin=0", "--ymax=639",
             f"--scoreThr={MOSAIC_SCORE_THR}", *README_CHAIN, "--int8",
             f"--weights={os.path.join(tmp, 'yolo11l_seed0.npz')}",
             f"--detect_outfile_json={os.path.join(tmp, 'int8.json')}",
             f"--detect_outfile={os.path.join(tmp, 'int8.reg')}"]
    from caesar_yolo_tpu_torch.cli import run as cli_run
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    rc, _ = cli_run.run(flags)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    expect = readme_launches(counters)
    expect.update(preproc=2, attn=4, upsample=4, qconv=n_int8)
    with open(os.path.join(tmp, "int8.json")) as f:
        cat = json.load(f)
    log(f"int8: cli.run --int8 yolo11l on the 640x640 crop (README chain): "
        f"{len(cat['objs'])} objects in {wall:.3f} s; launches {launches}")
    require(rc == 0 and launches == expect,
            f"int8: cli.run --int8 launched {launches}, expected {expect}")

    # the trained five-class model: int8 against bf16 on the held-out set
    # by the limits, the control against them; int8 calibrated in f32 (a
    # calibration mistake that only the CPU tests can see) and f32 (TF32
    # off) against bf16 by the same measures: what rounding alone does
    cal = make_multiclass_batch(q5.CAL_SEED0, 16, max_src=q5.MAX_SRC,
                                device=DEVICE)[0]
    q5_int8, q5_int8_f32cal = (quant.quantize_model(
        q5_model, quant.calibration_inputs_from_tiles(
            cal, img_size=MAIN_SIZE, compute_dtype=dt))
        for dt in (torch.bfloat16, torch.float32))
    t0 = time.perf_counter()
    mf1, pl, table = got = q5_heldout(q5, q5_int8)
    wall = time.perf_counter() - t0
    why, held, fails = int8_miss(q5_bf16, got)
    control = copy.deepcopy(q5_int8)
    for m in control.modules():
        if isinstance(m, Conv) and m.wq is not None:
            m.xs *= INT8_CONTROL_XS
    ctl = q5_heldout(q5, control)
    why_ctl, held_ctl, fails_ctl = int8_miss(q5_bf16, ctl)
    f32cal = q5_heldout(q5, q5_int8_f32cal)
    why_f32cal, held_f32cal, _ = int8_miss(q5_bf16, f32cal)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        pl32 = q5_heldout(q5, q5_model, compute_dtype=torch.float32)[1]
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    fails32 = rule_failures(q5_bf16[1], pl32)
    log(f"int8: the trained five-class model in int8 on {QUALITY5_EVAL} "
        f"held-out cutouts: macro-F1 {mf1:.4f} against bf16 "
        f"{q5_bf16[0]:.4f} (drop {q5_bf16[0] - mf1:+.4f}, limit "
        f"{INT8_MF1_DROP}), {QUALITY5_EVAL / wall:.1f} cutouts/s; the JAX "
        f"quality test's per-image rule (same count, IoU >= {INT8_IOU}, "
        f"same classes, scores within {INT8_SCORE_TOL}) holds on "
        f"{held}/{QUALITY5_EVAL} cutouts (limit {INT8_RULE_HELD}; failing "
        f"parts {fails}) -> {why or 'ok'}; the control (every xs times "
        f"{INT8_CONTROL_XS}): macro-F1 {ctl[0]:.4f} (drop "
        f"{q5_bf16[0] - ctl[0]:+.4f}),"
        f" rule held on {held_ctl}/{QUALITY5_EVAL} ({fails_ctl}) -> "
        f"{why_ctl or 'ok'}; calibrated in f32: macro-F1 {f32cal[0]:.4f}, "
        f"rule held on {held_f32cal}/{QUALITY5_EVAL} -> {why_f32cal or 'ok'}"
        f"; f32 against bf16 by the rule: "
        f"{QUALITY5_EVAL - sum(fails32.values())}/{QUALITY5_EVAL} "
        f"({fails32})")
    for name in (*CLASS_NAMES, "source_cumulative"):
        log(f"  {name}: {table[name]}")
    require(why is None, f"int8: the trained model in int8 against bf16: "
            f"{why}")
    require(why_ctl is not None, "int8: the control passed the limits")
    require(q5.passes_gate(table, CLASS_NAMES),
            "int8: the trained model in int8 is below the quality gate")

    # staged tiles/s of yolo11l at 640 px, batch 32: bf16, int8, int8, bf16
    kw = dict(img_size=MAIN_SIZE, score_thr=1e-3, iou_thr=0.5,
              pre_nms=PRE_NMS)
    engines = {"bf16": TileEngine(model, preprocessor=pre, **kw),
               "int8": TileEngine(qmodel, preprocessor=pre, **kw)}
    tiles = make_main_tiles(MAIN_BATCH * MAIN_BATCHES)
    staged = [engines["bf16"].put_tiles(tiles[i * MAIN_BATCH:
                                              (i + 1) * MAIN_BATCH])
              for i in range(MAIN_BATCHES)]
    tps = {"bf16": [], "int8": []}
    for name in ("bf16", "int8", "int8", "bf16"):
        tps[name].append(staged_tps(torch, engines[name], staged))
    log(on_card(f"int8: TileEngine staged tiles/s, yolo11l@{MAIN_SIZE} batch "
                f"{MAIN_BATCH}, README chain, in turns bf16 int8 int8 bf16: "
                f"bf16 {[round(v, 2) for v in tps['bf16']]}, int8 "
                f"{[round(v, 2) for v in tps['int8']]} (int8/bf16 "
                f"{sum(tps['int8']) / sum(tps['bf16']):.3f})"))
    row = qconv_timing(torch, cuda_qconv, top, err)
    return row, launches["qconv"]


def script(name):
    """The module scripts/<name>.py."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mosaic_planes(dev, rng):
    """[32, 512, 512] planes like the mosaic phase's, with the edge cases
    of the clip statistics: all zero, NaN-blanked rows, constant, a bright
    source (clipping bites), heavy duplicates (the pin's fallback)."""
    import torch
    x = rng.normal(0, 1, (MAIN_BATCH, MOSAIC_TILE, MOSAIC_TILE)
                   ).astype(np.float32)
    x[0] = 0.0
    x[1, :128] = np.nan
    x[2] = 3.0
    x[3, 256:264, 256:264] += 500.0
    x[4, :256] = 0.25
    x[:, :2] = 0.0
    return torch.from_numpy(x).to(dev)


def k5_planes(dev, rng, shape):
    """Planes of the given shape covering the clip statistics' edge cases
    (all zero, NaN-blanked rows, constant, a bright source, heavy
    duplicates), spread over as many calls as the plane count needs: the
    mosaic batch's planes at [32, 512, 512], else noise planes whose i-th
    of each call takes the next edge case."""
    import torch
    if shape == (MAIN_BATCH, MOSAIC_TILE, MOSAIC_TILE):
        return [mosaic_planes(dev, rng)]
    p, h, w = shape
    calls = []
    for c in range(-(-5 // p)):
        x = rng.normal(0, 1, shape).astype(np.float32)
        for i in range(p):
            case = (c * p + i) % 5
            if case == 0:
                x[i] = 0.0
            elif case == 1:
                x[i, : h // 4] = np.nan
            elif case == 2:
                x[i] = 3.0
            elif case == 3:
                x[i, h // 2:h // 2 + 8, w // 2:w // 2 + 8] += 500.0
            else:
                x[i, : h // 2] = 0.25
        x[:, :2] = 0.0
        calls.append(torch.from_numpy(x).to(dev))
    return calls


def parity_stats(torch, x, sig, route, cluster):
    """K5 on planes x against its plain version by cuda_stats.stats_mismatch
    (medians exact); the route's launch counter must show the route ran.
    Returns the largest abs difference where the kept counts agree."""
    from caesar_yolo_tpu_torch.ops import cuda_stats
    from caesar_yolo_tpu_torch.ops.stats import clip_stats_plain
    counter = f"{route}_launches"
    before = getattr(cuda_stats.clip_stats, counter)
    got = cuda_stats.clip_stats(x, *sig)
    torch.cuda.synchronize()
    require(getattr(cuda_stats.clip_stats, counter) == before + 1,
            f"sigma-clip kernel {tuple(x.shape)} did not take the {route} "
            f"route")
    ref = clip_stats_plain(x, None, *sig)
    why = cuda_stats.stats_mismatch(got, ref)
    same = got[1][:, 1] == ref[1][:, 1]
    e = ((got[0] - ref[0]).nan_to_num()[same].abs().max().item()
         if bool(same.any()) else 0.0)
    log(f"parity K5 sigma-clip stats {tuple(x.shape)} ({route} route, "
        f"cluster {cluster}) sigmas {sig}: max abs err {e:.3g}, medians "
        f"equal "
        f"{torch.equal(got[0][:, 1].nan_to_num(), ref[0][:, 1].nan_to_num())}"
        f", kept counts equal on {int(same.sum())}/{len(same)} planes, "
        f"all-zero planes NaN "
        f"{bool(got[0][got[1][:, 0] == 0].isnan().all())} (rule: "
        f"cuda_stats.stats_mismatch) -> {why or 'ok'}")
    require(why is None, f"sigma-clip kernel: {why}")
    require(bool(got[0][got[1][:, 0] == 0].isnan().all()),
            "an all-zero plane must give NaN statistics")
    return e


def phase_golden(torch):
    from caesar_yolo_tpu_torch.models.convert import load_model
    from caesar_yolo_tpu_torch.ops.transforms import build_preprocessor
    from caesar_yolo_tpu_torch.parallel.engine import TileEngine
    from caesar_yolo_tpu_torch.utils.boxes import catalog_mismatch

    fixtures = os.path.join(REPO, "tests", "fixtures")
    with np.load(os.path.join(fixtures, "torch_port_golden_v8n96.npz")) as f:
        golden = {k: f[k] for k in f.files}
    model, _ = load_model(os.path.join(fixtures, "yolov8n_synth96.npz"))
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        engine = TileEngine(
            model, compute_dtype=torch.float32, img_size=96, score_thr=0.3,
            iou_thr=0.5, max_det=300, pre_nms=512,
            preprocessor=build_preprocessor(zscale_stretch=True,
                                            normalize_minmax=True))
        boxes, scores, cls, valid, tile_ok, ndrop = engine.process(
            golden["tiles"])
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
    require(np.array_equal(tile_ok, golden["tile_ok"]), "golden tile_ok")
    require(np.array_equal(ndrop, golden["n_dropped"]), "golden n_dropped")
    for i in range(len(tile_ok)):
        r = golden["valid"][i]
        why = catalog_mismatch(
            (golden["boxes"][i][r], golden["scores"][i][r],
             golden["class_ids"][i][r]),
            (boxes[i][valid[i]], scores[i][valid[i]], cls[i][valid[i]]))
        require(why is None, f"golden tile {i}: {why}")
    log(f"golden: {int(valid.sum())} detections on {len(tile_ok)} tiles "
        f"match the JAX fixture (count, class, IoU >= 0.99, score within "
        f"1e-3)")


def phase_golden_train(torch):
    """2 f32 steps of the port's Trainer on the card against the JAX
    Trainer's committed numbers (tests/test_torch_train_golden.py writes
    them and holds the rule)."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import test_torch_train_golden as golden_train

    golden = golden_train.load_golden()
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = golden_train.port_run(golden, device="cuda")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
    why = golden_train.golden_mismatch(golden, got)
    rel = np.abs(got["loss"] - golden["loss"]) / golden["loss"]
    nz = golden["update_norms"] > 0
    urel = (np.abs(got["update_norms"] - golden["update_norms"])[nz]
            / golden["update_norms"][nz])
    log(f"golden-train: yolov8n_synth96 @96 f32, batch 4, 2 steps: losses "
        f"{got['loss'].tolist()} vs JAX {golden['loss'].tolist()} (max rel "
        f"err {rel.max():.3g}, limit {golden_train.LOSS_RTOL}); update norms "
        f"of {int(nz.sum())} tensors max rel err {urel.max():.3g} (limit "
        f"{golden_train.UPDATE_RTOL}) -> {why or 'ok'}")
    require(why is None, f"golden-train: {why}")


def phase_golden_eval(torch, counters, tmp):
    """The port's evaluate_dataset in f32 on the card, raw and through the
    CLAHE Pipeline, against the JAX evaluate_dataset's committed outputs
    (tests/test_torch_eval_golden.py writes them and holds the rule)."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import test_torch_eval_golden as golden_eval

    golden = golden_eval.load_golden()
    paths = golden_eval.write_set(os.path.join(tmp, "golden_eval"), golden)
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for c in counters.values():
        c.launches = 0
    clusters = counters["clahe"].cluster_launches
    try:
        got = golden_eval.port_outputs(paths, device="cuda")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
    batches = -(-len(paths) // golden_eval.CONFIG["batch_size"])
    launches = {k: counters[k].launches for k in CLAHE}
    launches["clahe cluster route"] = (counters["clahe"].cluster_launches
                                       - clusters)
    require(all(n == batches for n in launches.values()),
            f"golden-eval: K7 launches {launches}, expected {batches} each "
            f"(one cluster launch a batch)")
    why = golden_eval.golden_mismatch(golden, got)
    log(f"golden-eval: yolov8n_synth96 @96 f32 on {len(paths)} cutouts, "
        + "; ".join(f"{run}: {int(got[f'{run}_per_image'].sum())} detections,"
                    f" matched sources {int(got[f'{run}_counts'][0, 1])}/"
                    f"{int(got[f'{run}_counts'][0, 0])}, mAP50/50-95 "
                    f"{got[f'{run}_maps'].tolist()} vs JAX "
                    f"{golden[f'{run}_maps'].tolist()}"
                    for run in golden_eval.RUNS)
        + f"; K7 launches {launches} -> {why or 'ok'}")
    require(why is None, f"golden-eval: {why}")


def write_cutouts(root, n, seed):
    """n seeded FITS cutouts of 132 px with 1-3 Gaussian sources each and
    their YOLO label files; returns the path of a filelist of them."""
    from caesar_yolo_tpu_torch.utils.synth import write_labelled_cutouts

    paths = write_labelled_cutouts(root, n, sizes=(TRAIN_CUTOUT,), seed=seed)
    filelist = os.path.join(root, "filelist.txt")
    with open(filelist, "w") as f:
        f.write("\n".join(paths) + "\n")
    return filelist


def write_train_set(root):
    """48 seeded FITS cutouts of 132 px with 1-3 Gaussian sources each,
    YOLO label files and a dataset.yaml with a train split only."""
    write_cutouts(root, TRAIN_IMAGES, seed=3000)
    path = os.path.join(root, "dataset.yaml")
    with open(path, "w") as f:
        f.write(f"path: {root}\ntrain: images\nnames: [spurious, compact, "
                f"extended, extended-multisland, flagged]\n")
    return path


def phase_train(torch, counters, tmp, card):
    """cli.train on yolo11l@640 bf16 with validation, then a resume;
    returns the first run's launches."""
    from caesar_yolo_tpu_torch import evaluation
    from caesar_yolo_tpu_torch.cli import train as cli_train
    from caesar_yolo_tpu_torch.detect.letterbox import letterbox_batch
    from caesar_yolo_tpu_torch.models.convert import load_model
    from caesar_yolo_tpu_torch.models.yolo import build_model, init_weights
    from caesar_yolo_tpu_torch.parallel.engine import TileEngine
    from caesar_yolo_tpu_torch.train.augment import (augment_batch,
                                                     draw_augment_params)
    from caesar_yolo_tpu_torch.train.dataset import DetectionDataset
    from caesar_yolo_tpu_torch.train.trainer import Trainer

    data = write_train_set(os.path.join(tmp, "trainset"))
    val = write_cutouts(os.path.join(tmp, "valset"), VAL_IMAGES, seed=4000)
    ck = os.path.join(tmp, "runs")
    args = [f"--data={data}", "--model=yolo11l", f"--imgsz={MAIN_SIZE}",
            f"--batch={TRAIN_BATCH}", f"--checkpoint_dir={ck}",
            "--checkpoint_every=1", "--seed=0", f"--val_data={val}",
            "--val_every=1", f"--val_score_thr={MOSAIC_SCORE_THR}"]
    per_epoch = TRAIN_IMAGES // TRAIN_BATCH
    val_batches = -(-VAL_IMAGES // min(TRAIN_BATCH, 32))
    calib = min(8, per_epoch)       # precise-BN batches before a validation
    # name: (argv, steps, validations, of which intermediate)
    runs = {"train": (args + [f"--epochs={TRAIN_EPOCHS}"],
                      TRAIN_EPOCHS * per_epoch, TRAIN_EPOCHS,
                      TRAIN_EPOCHS - 1),
            "resume": (args + [f"--epochs={TRAIN_EPOCHS + 1}",
                               f"--resume={os.path.join(ck, 'step_2')}"],
                       per_epoch, 1, 0)}
    real_evaluate = evaluation.evaluate_dataset
    reports = []

    def timed_evaluate(*a, **kw):
        t0 = time.perf_counter()
        report = real_evaluate(*a, **kw)
        torch.cuda.synchronize()
        reports.append((report, time.perf_counter() - t0))
        return report

    def metric(report):
        f1 = report.f1.get("source", 0.0)
        return f1 if f1 is not None and np.isfinite(f1) else 0.0

    launches = {}
    torch.cuda.reset_peak_memory_stats()
    evaluation.evaluate_dataset = timed_evaluate
    try:
        for name, (argv, steps, n_val, n_inter) in runs.items():
            for c in counters.values():
                c.launches = 0
            counters["upsample_bwd"].copies = 0
            reports.clear()
            t0 = time.perf_counter()
            rc, trainer = cli_train.run(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches[name] = {k: c.launches for k, c in counters.items()}
            require(rc == 0, f"train {name} run failed")
            aug = steps + per_epoch          # + the precise-BN epoch
            plain = calib * n_inter + val_batches * n_val
            expect = {k: 0 for k in counters}
            expect.update({"attn": 2 * (aug + plain),
                           "upsample": 2 * (aug + plain),
                           "attn_bwd": 2 * steps, "upsample_bwd": 2 * steps,
                           "shift": 2 * aug, "nms": val_batches * n_val})
            log(f"train {name} launches: {launches[name]} (expected {expect}:"
                f" {steps} steps, {per_epoch} precise-BN forwards, every "
                f"batch augmented; {n_val} validations of {val_batches} "
                f"batches, {n_inter} after {calib} precise-BN batches of the "
                f"dataset)")
            require(launches[name] == expect,
                    f"train {name} run did not launch the kernels as expected")
            copies = counters["upsample_bwd"].copies
            read = launches[name]["upsample_bwd"]
            log(f"train {name}: K4's backward read {read} gradients, copied "
                f"{copies} of them first (expected 0: the concat's channel "
                f"slices are read where they lie)")
            require(copies == 0,
                    f"train {name}: K4's backward copied {copies} gradients")
            losses = [float(l) for _, l in trainer.loss_log]
            require(len(losses) == steps and np.isfinite(losses).all(),
                    f"train {name} losses {losses}")
            require(len(reports) == n_val and all(
                r.completeness["source"].n > 0 for r, _ in reports),
                f"train {name}: {len(reports)} validations")
            metrics = [metric(r) for r, _ in reports]
            log(f"train {name} ({card}): {steps} steps, losses "
                f"{[round(l, 4) for l in losses]}, optimizer step "
                f"{trainer.step}, {wall:.1f} s end to end; validation F1 "
                f"(source) {metrics}, evaluate_dataset "
                f"{[round(s, 3) for _, s in reports]} s for {VAL_IMAGES} "
                f"images each; best_metric {trainer.best_metric}")
            if name == "train":
                best = Trainer.load_checkpoint(os.path.join(ck, "best"))
                kept = Trainer.load_checkpoint(os.path.join(ck, "step_2"))
                require(best["best_metric"] == max(metrics)
                        == trainer.best_metric, "train: best checkpoint")
                require(kept["best_metric"] == metrics[0],
                        "train: step_2 does not carry the best metric")
        require(trainer.best_metric == max(kept["best_metric"], metrics[0]),
                f"resume lost the best metric {kept['best_metric']}")
        require(trainer.step == (TRAIN_EPOCHS + 1) * per_epoch, "resume step")
    finally:
        evaluation.evaluate_dataset = real_evaluate

    last = torch.load(os.path.join(ck, "last"), map_location="cpu",
                      weights_only=True)
    init = init_weights(build_model("yolo11l"), seed=0).state_dict()
    moved = sum(not torch.equal(last["params"][k], v)
                for k, v in init.items() if k.endswith((".w", ".gamma")))
    require(moved > 100, f"only {moved} weights moved")
    model, meta = load_model(os.path.join(ck, "last.npz"))
    engine = TileEngine(model, img_size=MAIN_SIZE, score_thr=1e-3,
                        pre_nms=PRE_NMS)
    boxes, scores, _, valid, tile_ok, _ = engine.process(
        make_main_tiles(MAIN_BATCH))
    require(boxes.shape == (MAIN_BATCH, 300, 4) and np.isfinite(boxes).all()
            and np.isfinite(scores).all(), "TileEngine on the trained weights")
    log(f"train: {moved} weight tensors moved; last.npz ({meta['model']}) "
        f"ran one batch of {MAIN_BATCH} through the TileEngine "
        f"({int(valid.sum())} detections, {int(tile_ok.sum())} tiles ok)")

    # step time: the resumed trainer on real augmented batches
    ds = DetectionDataset(data, img_size=MAIN_SIZE, batch_size=TRAIN_BATCH,
                          device_letterbox=True)
    imgs, labels, boxes, masks = next(iter(ds))
    imgs = letterbox_batch(torch.from_numpy(imgs).cuda().repeat(1, 1, 1, 3),
                           MAIN_SIZE)
    gen = torch.Generator().manual_seed(0)
    boxes, masks = torch.from_numpy(boxes), torch.from_numpy(masks)
    aug_ms, step_ms = [], []
    for _ in range(TRAIN_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = augment_batch(imgs, boxes, masks,
                              *draw_augment_params(gen, TRAIN_BATCH))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer.train_step(batch[0], labels, batch[1], batch[2])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        aug_ms.append((t1 - t0) * 1e3)
        step_ms.append((t2 - t1) * 1e3)
    total = np.mean(aug_ms) + np.mean(step_ms)
    log(f"train throughput ({card}): yolo11l@{MAIN_SIZE} bf16 batch "
        f"{TRAIN_BATCH}, mean of {TRAIN_TIMED_STEPS} steps after the first: "
        f"train_step {np.mean(step_ms):.1f} ms (min {np.min(step_ms):.1f}), "
        f"augment_batch {np.mean(aug_ms):.1f} ms, together {total:.1f} ms = "
        f"{TRAIN_BATCH * 1e3 / total:.1f} images/s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    precise_bn_dtypes(torch, trainer.model, [imgs, batch[0]])
    return launches["train"]


def precise_bn_dtypes(torch, model, batches):
    """calibrate_bn from the same weights and batches under a bfloat16 and
    a float32 TrainConfig: the statistics written into the weights and
    the EMA must be equal bit for bit (the forward is f32 under both)."""
    import copy

    from caesar_yolo_tpu_torch.train.trainer import TrainConfig, Trainer
    stats = {}
    for dtype in ("bfloat16", "float32"):
        t = Trainer(copy.deepcopy(model),
                    TrainConfig(img_size=MAIN_SIZE, batch_size=TRAIN_BATCH,
                                compute_dtype=dtype))
        t.calibrate_bn(batches)
        stats[dtype] = {f"{w}{k}": v for w, d in
                        (("", t.model.state_dict()), ("ema ", t.ema))
                        for k, v in d.items()
                        if k.endswith((".bn.mean", ".bn.var"))}
    ref, got = stats["float32"], stats["bfloat16"]
    differ = [k for k in ref if not torch.equal(got[k], ref[k])]
    log(f"train precise-BN: a bfloat16 TrainConfig's statistics over "
        f"{len(batches)} batches against a float32 config's from the same "
        f"weights: {len(ref) - len(differ)} of {len(ref)} tensors "
        f"(weights and EMA) bit-equal")
    require(len(ref) > 100 and set(got) == set(ref) and not differ,
            f"precise-BN differs by compute dtype: {differ[:4]}")

    # the forward is exact f32 on the card: one batch of 2 images against
    # the CPU's calibrate_bn, and a TF32 forward (cuDNN's default for an
    # f32 conv) against the same, which must be at least 4x further off
    from caesar_yolo_tpu_torch.models.layers import BatchNorm, train_mode
    x = batches[0][:2]
    cpu = Trainer(copy.deepcopy(model),
                  TrainConfig(img_size=MAIN_SIZE, batch_size=2),
                  device="cpu")
    card = Trainer(copy.deepcopy(model),
                   TrainConfig(img_size=MAIN_SIZE, batch_size=2))
    cpu.calibrate_bn([x])
    card.calibrate_bn([x])
    tf32_model = copy.deepcopy(model)
    names = {m: n for n, m in tf32_model.named_modules()
             if isinstance(m, BatchNorm)}
    collected: dict = {}
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad(), train_mode(tf32_model, collected):
            tf32_model(x.float().permute(0, 3, 1, 2))
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    tf32 = {f"{names[bn]}.{w}": v.float().cpu()
            for bn, pair in collected.items()
            for w, v in zip(("mean", "var"), pair)}
    want = {k: v for k, v in cpu.model.state_dict().items() if k in tf32}

    def gap(stats):
        return max(float((stats[k].cpu() - r).abs().max()
                         / r.abs().max().clamp_min(1e-30))
                   for k, r in want.items())

    f32_gap = gap(card.model.state_dict())
    tf32_gap = gap(tf32)
    log(f"train precise-BN: the card's statistics of 2 images against the "
        f"CPU's, the largest gap over {len(want)} tensors relative to the "
        f"tensor's largest value: {f32_gap:.3g} (calibrate_bn), "
        f"{tf32_gap:.3g} (a TF32 forward)")
    require(len(want) == len(tf32) > 100 and f32_gap * 4 <= tf32_gap,
            f"precise-BN's forward on the card is not exact f32: gap "
            f"{f32_gap:.3g} against TF32's {tf32_gap:.3g}")


def catalog_arrays(sources):
    """(boxes, scores, class_ids, edge, merged) of a stitched catalog."""
    boxes = np.asarray([[o["x1"], o["y1"], o["x2"], o["y2"]]
                        for o in sources], np.float64).reshape(-1, 4)
    return (boxes, np.asarray([o["score"] for o in sources]),
            np.asarray([o["class_id"] for o in sources]),
            np.asarray([bool(o["edge"]) for o in sources]),
            np.asarray([bool(o.get("merged", False)) for o in sources]))


def phase_golden_mosaic(torch, tmp):
    """The port's tiled SFinder in f32 on the committed mosaic against the
    JAX SFinder's catalogs, in the tile context on the streaming path and
    in the global context on the device-resident path
    (tests/test_torch_sfinder.py writes both fixtures)."""
    from caesar_yolo_tpu_torch.models.convert import load_model
    from caesar_yolo_tpu_torch.ops.transforms import build_preprocessor
    from caesar_yolo_tpu_torch.parallel.sfinder import SFinder, SFinderConfig
    from caesar_yolo_tpu_torch.utils.boxes import catalog_mismatch
    from caesar_yolo_tpu_torch.utils.fits import write_fits

    fixtures = os.path.join(REPO, "tests", "fixtures")
    path = os.path.join(tmp, "golden_mosaic.fits")
    model, _ = load_model(os.path.join(fixtures, "yolov8n_synth96.npz"))
    for context, fixture in (("tile", "torch_port_golden_mosaic_v8n96.npz"),
                             ("global",
                              "torch_port_golden_mosaic_global_v8n96.npz")):
        with np.load(os.path.join(fixtures, fixture)) as f:
            golden = {k: f[k] for k in f.files}
        if context == "tile":
            write_fits(golden["mosaic"], path)
        config = json.loads(str(golden["config"]))
        prev = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            sf = SFinder(model, SFinderConfig(
                image_path=path,
                outfile_json=os.path.join(tmp, "golden.json"),
                outfile_ds9=os.path.join(tmp, "golden.reg"),
                **config["sfinder"]),
                preprocessor=build_preprocessor(**config["preprocessing"]),
                engine_kwargs={"compute_dtype": torch.float32})
            require(sf.run_tiled() == 0, f"golden-mosaic {context} run "
                    f"failed")
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = prev
        ref = tuple(golden[k] for k in ("boxes", "scores", "class_ids",
                                        "edge", "merged"))
        why = catalog_mismatch(ref, catalog_arrays(sf.sources["sources"]))
        require(why is None, f"golden mosaic {context}: {why}")
        log(f"golden-mosaic {context} context ({sf.report.tiling_mode} "
            f"path): {len(ref[1])} stitched sources ({int(ref[4].sum())} "
            f"merged, {int(ref[3].sum())} edge) on {sf.report.n_tiles} "
            f"tiles match the JAX SFinder's catalog (count, class, IoU >= "
            f"0.99, score within 1e-3, edge and merged flags)")


def make_main_tiles(n):
    from caesar_yolo_tpu_torch.utils.synth import make_mosaic
    tiles = np.stack([make_mosaic(MAIN_SIZE, MAIN_SIZE, n_sources=25,
                                  noise_sigma=0.1, seed=1000 + i)[0]
                      for i in range(n)])
    tiles[MAIN_BATCH // 2] = 0.0                   # degenerate, batch 0
    return tiles[..., None]


def phase_main(torch, counters):
    from caesar_yolo_tpu_torch.detect.analyzer import (Analyzer,
                                                       AnalyzerOutputs)
    from caesar_yolo_tpu_torch.detect.predictor import Predictor
    from caesar_yolo_tpu_torch.models import cuda_epilogue
    from caesar_yolo_tpu_torch.models.layers import Conv, Conv2dRaw
    from caesar_yolo_tpu_torch.models.yolo import build_model, init_weights
    from caesar_yolo_tpu_torch.ops.transforms import build_preprocessor
    from caesar_yolo_tpu_torch.parallel.engine import TileEngine

    model = init_weights(build_model("yolo11l"), seed=0)
    pre = build_preprocessor(zscale_stretch=True, normalize_minmax=True)
    # seeded random weights leave the class scores at the head's bias
    # priors (~1.6e-4, 6.2e-4 and 2.5e-3 at strides 8/16/32): 1e-3 lets the
    # 400 stride-32 anchors of every tile through, so that NMS works on a
    # full window of large, overlapping, score-tied boxes
    kw = dict(img_size=MAIN_SIZE, score_thr=1e-3, iou_thr=0.5,
              pre_nms=PRE_NMS)
    engine = TileEngine(model, preprocessor=pre, **kw)
    analyzer_pred = Predictor(model, **kw)
    tiles = make_main_tiles(MAIN_BATCH * MAIN_BATCHES)
    batches = [tiles[i * MAIN_BATCH:(i + 1) * MAIN_BATCH]
               for i in range(MAIN_BATCHES)]

    for c in counters.values():
        c.launches = 0
    cuda_epilogue.conv_epilogue.launches = 0
    outs = [engine.process(bt) for bt in batches]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        analyzer = Analyzer(analyzer_pred, preprocessor=pre,
                            outputs=AnalyzerOutputs(
                                outfile_json=os.path.join(tmp, "cat.json"),
                                outfile_ds9=os.path.join(tmp, "cat.reg")))
        status = analyzer.predict(tiles[0, :, :, 0], "tile0")
        torch.cuda.synchronize()
        with open(os.path.join(tmp, "cat.json")) as f:
            catalog = json.load(f)
        with open(os.path.join(tmp, "cat.reg")) as f:
            regions = f.read().splitlines()
    launches = {name: c.launches for name, c in counters.items()}
    launches["epilogue"] = cuda_epilogue.conv_epilogue.launches
    forwards = MAIN_BATCHES + 1
    n_conv = sum(isinstance(m, (Conv, Conv2dRaw))
                 for m in engine.model.modules())
    log(f"main path launches: {launches} over {forwards} forward passes "
        f"({n_conv} convs a forward)")
    require(launches["nms"] == forwards and launches["preproc"] == forwards
            and launches["attn"] == 2 * forwards
            and launches["upsample"] == 2 * forwards
            and launches["epilogue"] == n_conv * forwards
            and not any(launches[k] for k in TRAIN_ONLY + CLAHE),
            f"main path did not run every kernel as expected: {launches}")

    n_det = 0
    for bi, (boxes, scores, cls, valid, tile_ok, ndrop) in enumerate(outs):
        require(boxes.shape == (MAIN_BATCH, 300, 4) and scores.shape ==
                (MAIN_BATCH, 300) and valid.shape == (MAIN_BATCH, 300)
                and tile_ok.shape == (MAIN_BATCH,), "main path shapes")
        require(np.isfinite(boxes).all() and np.isfinite(scores).all(),
                "main path outputs not finite")
        require((boxes >= 0).all() and (boxes <= MAIN_SIZE).all(),
                "boxes outside the tile")
        expect_ok = np.ones(MAIN_BATCH, bool)
        if bi == 0:
            expect_ok[MAIN_BATCH // 2] = False
        require(np.array_equal(tile_ok, expect_ok), f"tile_ok {tile_ok}")
        require(not valid[~tile_ok].any(), "detections on a degenerate tile")
        require(valid[tile_ok].any(axis=1).all(), "a valid tile kept nothing")
        n_det += int(valid.sum())
    require(status == 0, "Analyzer.predict skipped a valid tile")
    require(len(regions) == 2 + len(catalog["objs"]), "DS9 file")
    log(f"main path: yolo11l@{MAIN_SIZE} bf16, {MAIN_BATCHES} batches of "
        f"{MAIN_BATCH}: {n_det} detections; Analyzer catalog of "
        f"{len(catalog['objs'])} objects and a DS9 file of "
        f"{len(regions)} lines written")
    staged = [engine.put_tiles(bt) for bt in batches]
    tps = [staged_tps(torch, engine, staged) for _ in range(2)]
    log(on_card(f"main path: staged tiles/s, yolo11l@{MAIN_SIZE} bf16 batch "
                f"{MAIN_BATCH}, two runs: {[round(v, 2) for v in tps]}"))
    return engine, model, batches, launches


def phase_epilogue(torch, engine, model, batches):
    """K10 against its plain version on every bf16 conv of one yolo11l@640
    forward (batch 32), on each call's own input: conv_epilogue wrapped so
    that each call also runs epilogue_plain on the same tensors (the
    engine's graphs dropped first, since a replay calls no wrapper).
    Returns (the timing inputs of the most launched shape, max abs
    err)."""
    from caesar_yolo_tpu_torch.models import cuda_epilogue
    from caesar_yolo_tpu_torch.models.layers import Conv, Conv2dRaw
    kernel, shapes, seen = cuda_epilogue.conv_epilogue, Counter(), {}

    def held(y, scale, shift, act):
        out = kernel(y, scale, shift, act)
        ref = cuda_epilogue.epilogue_plain(y, scale, shift, act)
        key = (tuple(y.shape), scale is not None, bool(act))
        require(torch.equal(out, ref), f"K10 differs in yolo11l at {key}")
        shapes[key] += 1
        seen.setdefault(key, (y, scale, shift, act))
        return out

    n_conv = sum(isinstance(m, (Conv, Conv2dRaw))
                 for m in engine.model.modules())
    # the kernel counts its launches on the module's name, `held` here
    held.launches = kernel.launches
    cuda_epilogue.conv_epilogue = held
    try:
        engine.update_params(model)
        staged = engine.put_tiles(batches[0])
        engine.process_async(staged)
        torch.cuda.synchronize()
    finally:
        cuda_epilogue.conv_epilogue = kernel
        kernel.launches = held.launches
    log(f"parity K10 on yolo11l@{MAIN_SIZE} batch {MAIN_BATCH} bf16: "
        f"{sum(shapes.values())} conv epilogues ({n_conv} convs) of "
        f"{len(shapes)} shapes, every one bit-equal to epilogue_plain on "
        f"its own input")
    require(sum(shapes.values()) == n_conv, "K10 parity missed a conv")
    top = max(shapes, key=lambda key: (shapes[key], np.prod(key[0])))
    return seen[top], 0.0


def epilogue_timing(torch, inputs, err):
    """K10's row of the kernels line at the most launched shape of the
    main path: CUDA events and device time, the plain version, the bound
    (bytes: 4 read and 2 written an element and the channel vectors), no
    library call (none adds an f32 bias, rounds once and applies the
    reference's SiLU)."""
    from caesar_yolo_tpu_torch.models import cuda_epilogue
    y, scale, shift, act = inputs
    kernel = lambda: cuda_epilogue.conv_epilogue(y, scale, shift, act)
    nbytes = 6 * y.numel() + 8 * y.shape[1]
    row = dict(ms=time_ms(torch, kernel, iters=100, warmup=10),
               plain_ms=time_ms(torch, lambda: cuda_epilogue.epilogue_plain(
                   y, scale, shift, act)),
               library_ms=None, bound=bound_ms(nbytes, 0, "float32"),
               max_abs_err=err)
    log(on_card(f"timing K10 conv epilogue {tuple(y.shape)} f32 -> bf16 "
                f"(scale {scale is not None}, act {act}): {row['ms']:.5f} ms "
                f"(device {device_ms(torch, kernel):.5f}), plain "
                f"{row['plain_ms']:.5f}, bound {row['bound'][0]:.6f} "
                f"({row['bound'][1]})"))
    return row


# the export phase: the fresh process that loads the README-chain artifact
# (deploy.load_detector alone: none of the model code or JAX may be
# imported), runs the main phase's batches, and reports the kernels
# launched inside the artifact
EXPORT_CHILD = """
import json, sys
import numpy as np
import torch
from caesar_yolo_tpu_torch.deploy import load_detector
from caesar_yolo_tpu_torch.detect import cuda_nms
from caesar_yolo_tpu_torch.models import cuda_attn, cuda_epilogue
from caesar_yolo_tpu_torch.ops import cuda_preproc, cuda_upsample
art, tiles, out = sys.argv[1:4]
with open(art, "rb") as f:
    det = load_detector(f.read())
batches = np.load(tiles)
outs = [[t.cpu().numpy() for t in det(b)] for b in batches]
np.savez(out, *[o for b in outs for o in b])
counters = {"nms": cuda_nms.nms_suppress, "attn": cuda_attn.attention,
            "preproc": cuda_preproc.zscale_minmax,
            "upsample": cuda_upsample.upsample2x_forward,
            "epilogue": cuda_epilogue.conv_epilogue}
blocked = ("caesar_yolo_tpu_torch.models.yolo",
           "caesar_yolo_tpu_torch.models.layers",
           "caesar_yolo_tpu_torch.ops.transforms",
           "caesar_yolo_tpu_torch.detect.predictor",
           "caesar_yolo_tpu_torch.parallel.engine", "jax", "caesar_yolo_tpu")
print(json.dumps({"launches": {k: c.launches for k, c in counters.items()},
                  "imported": [m for m in blocked if m in sys.modules]}))
"""
EXPORT_TIMEOUT_S = 600
SERVE_REQUESTS = 5


class artifact_engine:
    """A loaded artifact in the place of a TileEngine for staged_tps."""

    def __init__(self, det):
        self.det = det

    def process_async(self, tiles):
        return self.det(tiles)


def same_outputs(ref, got):
    """True when two lists of the six outputs are equal bit for bit."""
    return len(ref) == len(got) and all(
        np.asarray(r).dtype == np.asarray(g).dtype
        and np.array_equal(np.asarray(r), np.asarray(g))
        for r, g in zip(ref, got))


def export_artifact(torch, tmp, name, model, **kw):
    """export_detector on CUDA -> (path, load seconds, the loaded
    Detector), the export and load times and the size printed."""
    from caesar_yolo_tpu_torch.deploy import export_detector, load_detector
    t0 = time.perf_counter()
    blob = export_detector(model, **kw)
    t_export = time.perf_counter() - t0
    path = os.path.join(tmp, f"{name}.cyx")
    with open(path, "wb") as f:
        f.write(blob)
    t0 = time.perf_counter()
    det = load_detector(blob)
    t_load = time.perf_counter() - t0
    log(on_card(f"export {name}: export {t_export:.3f} s, artifact "
                f"{len(blob) / 1e6:.3f} MB ({artifact_parts(det, blob)}), "
                f"load {t_load:.3f} s"))
    return path, det


def artifact_parts(det, blob):
    """Where an artifact's bytes are: its archive's entries by kind, and
    the tensors the loaded program holds."""
    import io
    import zipfile
    kinds = Counter()
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        for info in z.infolist():
            kinds[info.filename.split("/")[-2]] += info.file_size
    held = sum(t.numel() * t.element_size() for t in
               list(det.program.state_dict.values())
               + [c for c in det.program.constants.values()
                  if hasattr(c, "element_size")])
    return (", ".join(f"{k} {v / 1e6:.3f} MB" for k, v in kinds.most_common())
            + f"; tensors held {held / 1e6:.3f} MB")


def aten_ops(torch, fn):
    """The ops fn() dispatches on the host, by name (a caesar_yolo op
    counts once: the dispatches inside its body are not seen)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen[str(func.overloadpacket)] += 1
            return func(*args, **(kwargs or {}))

    with Ops() as mode:
        fn()
        torch.cuda.synchronize()
    return mode.seen


def launch_counts(counters, fn):
    """fn() with every kernel counter at 0 -> (its result, the launches)."""
    for c in counters.values():
        c.launches = 0
    out = fn()
    return out, {k: c.launches for k, c in counters.items()}


def http_json(url, data=None, timeout=120):
    import urllib.request
    req = urllib.request.Request(url, data=data)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)


def phase_serve(torch, tmp, art, batch, ref):
    """cli.serve on the artifact in a subprocess: /healthz, then one raw
    and one .npy /detect of `batch`, which must agree with each other and
    with the in-process artifact's valid rows `ref`; /detect latency,
    median of SERVE_REQUESTS raw requests."""
    import io
    import urllib.error
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "caesar_yolo_tpu_torch.cli.serve",
         f"--artifact={art}", f"--port={port}"], cwd=tmp,
        env=dict(os.environ, PYTHONPATH=REPO), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    base = f"http://127.0.0.1:{port}"
    try:
        t0 = time.perf_counter()
        while True:
            if proc.poll() is not None:
                raise Failed("cli.serve exited: "
                             + proc.stdout.read().decode()[-4000:])
            require(time.perf_counter() - t0 < EXPORT_TIMEOUT_S,
                    "cli.serve did not answer /healthz in time")
            try:
                health = http_json(f"{base}/healthz", timeout=5)
                break
            except (urllib.error.URLError, ConnectionError, OSError):
                time.sleep(0.5)
        t_up = time.perf_counter() - t0
        require(health == {"status": "ok", "input_shape": list(batch.shape),
                           "dtype": "float32"}, f"/healthz {health}")
        raw = np.ascontiguousarray(batch, "<f4").tobytes()
        buf = io.BytesIO()
        np.save(buf, batch)
        resp = http_json(f"{base}/detect", raw)
        require(http_json(f"{base}/detect", buf.getvalue()) == resp,
                "/detect: the .npy answer differs from the raw one")
        boxes, scores, cls, valid, tile_ok, ndrop = ref
        for i, d in enumerate(resp["detections"]):
            v = valid[i]
            require(d["boxes"] == boxes[i][v].astype(float).tolist()
                    and d["scores"] == scores[i][v].astype(float).tolist()
                    and d["class_ids"] == cls[i][v].astype(int).tolist(),
                    f"/detect tile {i} differs from the artifact")
        require(resp["tile_ok"] == tile_ok.tolist()
                and resp["n_dropped"] == ndrop.tolist(),
                "/detect tile_ok or n_dropped differs from the artifact")
        lat = []
        for _ in range(SERVE_REQUESTS):
            t0 = time.perf_counter()
            http_json(f"{base}/detect", raw)
            lat.append(time.perf_counter() - t0)
    finally:
        proc.terminate()
        try:
            proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
    log(on_card(f"export serve: cli.serve up in {t_up:.3f} s (load and warm "
                f"included); /detect of {batch.shape[0]} tiles "
                f"({len(raw) / 1e6:.1f} MB raw f32), {int(valid.sum())} "
                f"detections, raw and .npy equal to the artifact; latency "
                f"median of {SERVE_REQUESTS} {float(np.median(lat)):.4f} s "
                f"({[round(v, 4) for v in lat]})"))


def op_overhead_us(torch):
    """Host microseconds a call of K10 directly and through its op
    caesar_yolo::conv_epilogue (on a small channels_last input), each the
    median of five runs of 200 calls."""
    from caesar_yolo_tpu_torch.models import cuda_epilogue
    y = torch.randn((1, 64, 8, 8), device=DEVICE).contiguous(
        memory_format=torch.channels_last)
    shift = torch.zeros(64, device=DEVICE)
    calls = {"direct": lambda: cuda_epilogue.conv_epilogue(y, None, shift,
                                                           True),
             "op": lambda: torch.ops.caesar_yolo.conv_epilogue(y, None, shift,
                                                               True)}
    out = {}
    for name, fn in calls.items():
        runs = []
        for _ in range(5):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            runs.append((time.perf_counter() - t0) / 200 * 1e6)
            torch.cuda.synchronize()
        out[name] = float(np.median(runs))
    return out


def native_read_ms(tmp):
    """One read of 32 windows of MOSAIC_TILE px from a MOSAIC_SIZE FITS
    mosaic: utils/fits_native.read_tiles_batch (the native reader) against
    utils/fits.read_fits_crop (the memory-map slice the SFinder reads),
    each the median of five, and the windows equal -> (native ms or None
    when the library is not available, memory-map ms)."""
    from caesar_yolo_tpu_torch.utils import fits_native
    from caesar_yolo_tpu_torch.utils.fits import read_fits_crop
    from caesar_yolo_tpu_torch.utils.synth import write_mosaic_fits
    path = os.path.join(tmp, "native_read.fits")
    write_mosaic_fits(path, nx=MOSAIC_SIZE, ny=MOSAIC_SIZE, n_sources=50,
                      seed=21)
    rng = np.random.default_rng(8)
    x0 = rng.integers(0, MOSAIC_SIZE - MOSAIC_TILE, MAIN_BATCH)
    y0 = rng.integers(0, MOSAIC_SIZE - MOSAIC_TILE, MAIN_BATCH)
    wins = [[int(x), int(x) + MOSAIC_TILE, int(y), int(y) + MOSAIC_TILE]
            for x, y in zip(x0, y0)]

    def timed(fn):
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            out = fn()
            runs.append((time.perf_counter() - t0) * 1e3)
        return out, float(np.median(runs))

    mm, mm_ms = timed(lambda: [read_fits_crop(path, *w)[0] for w in wins])
    if not fits_native.available():
        return None, mm_ms
    nat, nat_ms = timed(lambda: fits_native.read_tiles_batch(path, wins))
    require(nat is not None and all(np.array_equal(a, b)
                                    for a, b in zip(nat, mm)),
            "native FITS reader: windows differ from read_fits_crop")
    return nat_ms, mm_ms


def phase_export(torch, counters, engine, batches, tmp):
    """The serving artifacts on the card (deploy.py): yolo11l@640 bf16
    with the README chain, loaded in a fresh process that imports no model
    code, equal to the live engine bit for bit on the main phase's batches,
    with K1-K4 and K10 launched inside it; an int8 artifact against the
    live int8 engine (K9); a bkg + chan3 + min-max artifact on 512 px
    tiles (K5, K6); cli.serve on the first; export, load and staged
    tiles/s and the ops dispatched a batch; a call's host cost direct and
    through an op; the native FITS reader's 32-window read.  Returns the
    launches inside the artifacts."""
    from caesar_yolo_tpu_torch.cli.preproc_args import (
        build_preprocessor_from_args,
    )
    from caesar_yolo_tpu_torch.cli.run import parse_args
    from caesar_yolo_tpu_torch.models import cuda_epilogue, quant
    from caesar_yolo_tpu_torch.models.yolo import build_model, init_weights
    from caesar_yolo_tpu_torch.ops.transforms import build_preprocessor
    from caesar_yolo_tpu_torch.parallel.engine import TileEngine

    counters = dict(counters, epilogue=cuda_epilogue.conv_epilogue)
    model = init_weights(build_model("yolo11l"), seed=0)
    pre = build_preprocessor(zscale_stretch=True, normalize_minmax=True)
    kw = dict(img_size=MAIN_SIZE, score_thr=1e-3, iou_thr=0.5,
              pre_nms=PRE_NMS)
    shape = dict(tile_shape=batches[0].shape[1:], batch=MAIN_BATCH)
    live = [engine.process(bt) for bt in batches]
    inside = {}

    # the README chain: a fresh process loads and runs it
    art, det = export_artifact(torch, tmp, "readme", model, preprocessor=pre,
                               **shape, **kw)
    tiles_npy = os.path.join(tmp, "export_tiles.npy")
    np.save(tiles_npy, np.stack(batches))
    out_npz = os.path.join(tmp, "export_out.npz")
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c", EXPORT_CHILD, art, tiles_npy, out_npz],
        capture_output=True, text=True, timeout=EXPORT_TIMEOUT_S,
        env=dict(os.environ, PYTHONPATH=REPO), cwd=tmp)
    t_child = time.perf_counter() - t0
    require(child.returncode == 0, "export: the fresh process failed:\n"
            + child.stderr[-4000:])
    report = json.loads(child.stdout.strip().splitlines()[-1])
    require(not report["imported"], f"export: the fresh process imported "
            f"{report['imported']}")
    with np.load(out_npz) as f:
        got = [f[f"arr_{i}"] for i in range(6 * len(batches))]
    for b, ref in enumerate(live):
        require(same_outputs(ref, got[6 * b:6 * b + 6]),
                f"export: the artifact's batch {b} differs from the live "
                f"engine")
    n = report["launches"]
    nb = len(batches)
    require(n["nms"] == n["preproc"] == nb and n["attn"] == n["upsample"]
            == 2 * nb and n["epilogue"] > 100 * nb,
            f"export: kernels launched inside the artifact {n}")
    inside["readme"] = n
    log(on_card(f"export readme: a fresh process (deploy.py only; no model "
                f"code, no JAX) ran {nb} batches of {MAIN_BATCH} equal to "
                f"the live engine bit for bit in {t_child:.3f} s (process "
                f"start and load included); launches inside the artifact "
                f"{n}"))
    # staged tiles/s of the artifact and of the live engine, in turns
    staged = [engine.put_tiles(bt) for bt in batches]
    ab = [staged_tps(torch, e, staged) for e in (
        engine, artifact_engine(det), artifact_engine(det), engine)]
    log(on_card(f"export readme: staged tiles/s live {ab[0]:.2f}, artifact "
                f"{ab[1]:.2f}, artifact {ab[2]:.2f}, live {ab[3]:.2f} (no "
                f"gain claimed)"))
    ops_live = aten_ops(torch, lambda: engine.process_async(staged[0]))
    ops_art = aten_ops(torch, lambda: det(staged[0]))
    more = (ops_art - ops_live).most_common(8)
    fewer = (ops_live - ops_art).most_common(8)
    log(f"export readme: ops dispatched a batch, live "
        f"{sum(ops_live.values())}, artifact {sum(ops_art.values())}; the "
        f"artifact's extra {more}; the live path's extra {fewer}")
    ref0 = [t.cpu().numpy() for t in det(batches[0])]
    phase_serve(torch, tmp, art, batches[0], ref0)
    ov = op_overhead_us(torch)
    log(on_card(f"export: host us a K10 call on [1,64,8,8], direct "
                f"{ov['direct']:.2f}, through caesar_yolo::conv_epilogue "
                f"{ov['op']:.2f} (medians of 5 x 200 calls)"))
    del det

    # int8: calibrated on the main tiles, against the live int8 engine
    calib = quant.calibration_inputs_from_tiles(
        batches[0][:4], preprocessor=pre, img_size=MAIN_SIZE)
    qmodel = quant.quantize_model(model, calib)
    qlive = TileEngine(qmodel, preprocessor=pre, **kw)
    ref = qlive.process(batches[0])
    _, qdet = export_artifact(torch, tmp, "int8", qmodel, preprocessor=pre,
                              **shape, **kw)
    got, n = launch_counts(counters, lambda: [t.cpu().numpy()
                                              for t in qdet(batches[0])])
    require(same_outputs(ref, got), "export: the int8 artifact differs "
            "from the live int8 engine")
    require(n["qconv"] > 100 and n["nms"] == n["preproc"] == 1,
            f"export int8: kernels launched inside the artifact {n}")
    inside["int8"] = n
    log(f"export int8: equal to the live --int8 engine bit for bit; "
        f"launches inside the artifact {n}")
    del qlive, qdet

    # bkg + chan3 + min-max on the mosaic phase's 512 px tiles
    mpre = build_preprocessor_from_args(parse_args(
        ["--weights=w.npz", *MOSAIC_CHAIN]))
    mtiles = np.ascontiguousarray(batches[1][:, :MOSAIC_TILE, :MOSAIC_TILE])
    mlive = TileEngine(model, preprocessor=mpre, **kw)
    ref = mlive.process(mtiles)
    _, mdet = export_artifact(torch, tmp, "mosaic", model, preprocessor=mpre,
                              tile_shape=mtiles.shape[1:], batch=MAIN_BATCH,
                              **kw)
    got, n = launch_counts(counters, lambda: [t.cpu().numpy()
                                              for t in mdet(mtiles)])
    require(same_outputs(ref, got), "export: the mosaic-chain artifact "
            "differs from the live engine")
    require(n["stats"] == 3 and n["histeq"] == 1 and n["nms"] == 1
            and n["attn"] == 2, f"export mosaic: kernels launched inside "
            f"the artifact {n}")
    inside["mosaic"] = n
    log(f"export mosaic: bkg + chan3 + min-max at {MOSAIC_TILE} px equal to "
        f"the live engine bit for bit; launches inside the artifact {n}")
    del mlive, mdet
    torch.cuda.empty_cache()

    nat_ms, mm_ms = native_read_ms(tmp)
    log(on_card(f"export: one read of {MAIN_BATCH} windows of {MOSAIC_TILE} "
                f"px from a {MOSAIC_SIZE} px FITS mosaic (median of 5): "
                f"native reader "
                f"{'not available' if nat_ms is None else f'{nat_ms:.3f} ms'}"
                f", memory-map slices {mm_ms:.3f} ms"))
    return inside


def mosaic_grid():
    """The mosaic phase's tile windows (x0, x1, y0, y1)."""
    from caesar_yolo_tpu_torch.utils.tiling import generate_tiles
    return generate_tiles(0, MOSAIC_SIZE - 1, 0, MOSAIC_SIZE - 1, MOSAIC_TILE,
                          MOSAIC_TILE, 0.5, 0.5)


def mosaic_batches(grid, banded):
    """Batches of MAIN_BATCH a tiled run dispatches: one series a tile
    shape, or one a shape within each grid row on the banded path."""
    key = ((lambda x0, x1, y0, y1: (y0, y1, x1 - x0)) if banded
           else (lambda x0, x1, y0, y1: (x1 - x0, y1 - y0)))
    groups = Counter(key(*t) for t in grid)
    return sum(-(-n // MAIN_BATCH) for n in groups.values())


def mosaic_cli(tmp, chain=MOSAIC_CHAIN):
    """The mosaic phase's CLI flags: image, weights, threshold and chain."""
    return [f"--image={os.path.join(tmp, 'mosaic.fits')}",
            f"--weights={os.path.join(tmp, 'yolo11l_seed0.npz')}",
            f"--scoreThr={MOSAIC_SCORE_THR}", *chain]


def run_tiled(torch, flags, banded):
    """A tiled run of cli.run's configuration (banded: with the device-
    tiling cap at one band's bytes, which the CLI has no flag for) ->
    (rc, SFinder, wall s)."""
    from caesar_yolo_tpu_torch.cli import run as cli_run
    t0 = time.perf_counter()
    if banded:
        drill = script("torch_drill_banded_resume")
        rc, sf = drill.run_with_cap(flags, drill.band_bytes(flags))
    else:
        rc, sf = cli_run.run(flags)
    torch.cuda.synchronize()
    return rc, sf, time.perf_counter() - t0


def route_counts(counters):
    return {k: (getattr(c, "cluster_launches", None),
                getattr(c, "stream_launches", None))
            for k, c in counters.items()}


def phase_mosaic(torch, counters, tmp):
    """The CLI on a seeded 2560x2560 FITS mosaic with yolo11l@640 bf16: the
    tiled run once per device-tiling mode and statistics context, then a
    serial run on a 640x640 crop.  Returns the launches of each run, each
    tiled run's tiles/s and the run of the "auto" mode."""
    from caesar_yolo_tpu_torch.models.convert import save_params
    from caesar_yolo_tpu_torch.models.yolo import build_model, init_weights
    from caesar_yolo_tpu_torch.utils.boxes import catalog_mismatch
    from caesar_yolo_tpu_torch.utils.synth import write_mosaic_fits

    image = os.path.join(tmp, "mosaic.fits")
    write_mosaic_fits(image, nx=MOSAIC_SIZE, ny=MOSAIC_SIZE, n_sources=400,
                      seed=0, blank_border=16)
    save_params(init_weights(build_model("yolo11l"), seed=0),
                os.path.join(tmp, "yolo11l_seed0.npz"),
                meta={"model": "yolo11l", "num_classes": 5})
    grid = mosaic_grid()
    shapes = Counter((x1 - x0, y1 - y0) for x0, x1, y0, y1 in grid)
    rows = {(y0, y1) for _, _, y0, y1 in grid}
    mosaic_bytes = MOSAIC_SIZE * MOSAIC_SIZE * 4
    implied = {"stream": sum((x1 - x0) * (y1 - y0) for x0, x1, y0, y1
                             in grid) * 4,
               "full": mosaic_bytes,
               "band": sum(MOSAIC_SIZE * (y1 - y0) for y0, y1 in rows) * 4}
    log(f"mosaic grid: {len(grid)} tiles in shapes {dict(shapes)}, "
        f"{mosaic_batches(grid, False)} batches of {MAIN_BATCH} "
        f"({mosaic_batches(grid, True)} on the banded path); pixel bytes "
        f"host -> device implied by each path: windows {implied['stream']}, "
        f"mosaic {implied['full']}, bands {implied['band']}")
    launches, tps, catalogs, runs = {}, {}, {}, {}
    for name, (chain, extra, path) in MOSAIC_MODES.items():
        flags = [*mosaic_cli(tmp, chain), *MOSAIC_TILED, *extra,
                 f"--detect_outfile_json={os.path.join(tmp, name)}.json",
                 f"--detect_outfile={os.path.join(tmp, name)}.reg"]
        for c in counters.values():
            c.launches = 0
        routes = route_counts(counters)
        rc, sf, wall = run_tiled(torch, flags, name == "band")
        launches[name] = {k: c.launches for k, c in counters.items()}
        after = route_counts(counters)
        stream = {k: (after[k][1] or 0) - (routes[k][1] or 0)
                  for k in counters}
        require(rc == 0, f"mosaic {name} run failed")
        rep = sf.report
        batches = mosaic_batches(grid, name == "band")
        expect = {k: 0 for k in counters}
        expect.update({k: n * batches for k, n in PER_FORWARD.items()})
        if name.startswith("global"):   # the chain ran once, on the mosaic
            expect.update(stats=3 * (name == "global"),
                          histeq=int(name == "global"),
                          preproc=int(name == "global-readme"))
        log(f"mosaic {name} launches: {launches[name]} (expected {expect} "
            f"over {batches} forward passes); stream-route launches "
            f"{ {k: n for k, n in stream.items() if n} }")
        require(launches[name] == expect,
                f"mosaic {name} run did not launch the kernels as expected")
        if name.startswith("global"):
            require(stream == {**{k: 0 for k in counters},
                               **{k: n for k, n in expect.items() if n
                                  and k in ("stats", "histeq", "preproc")}},
                    f"mosaic {name}: the whole-mosaic plane must take the "
                    f"stream routes ({stream})")
        require(rep.tiling_mode == path, f"mosaic {name} took the "
                f"{rep.tiling_mode!r} path, not {path!r}")
        require(rep.n_tiles == len(grid) and not rep.tile_errors,
                f"mosaic tiles {rep.n_tiles}, errors {rep.tile_errors}")
        with open(os.path.join(tmp, f"{name}.json")) as f:
            objs = json.load(f)["sources"]
        with open(os.path.join(tmp, f"{name}.reg")) as f:
            regions = f.read().splitlines()
        require(len(objs) > 0, f"mosaic {name}: empty catalog")
        require(len(regions) == 2 + len(objs), f"mosaic {name}: DS9 file")
        boxes = catalog_arrays(objs)[0]
        require(np.isfinite(boxes).all() and (boxes >= 0).all()
                and (boxes <= MOSAIC_SIZE).all(), f"mosaic {name}: boxes")
        catalogs[name], runs[name] = objs, sf
        tps[name] = rep.n_tiles / wall
        log(f"mosaic {name}: {rep.n_tiles} tiles in {wall:.3f} s end to end "
            f"= {tps[name]:.2f} tiles/s (yolo11l@640 bf16, batch "
            f"{MAIN_BATCH}), {rep.tiling_mode} path, {rep.h2d_bytes} pixel "
            f"bytes host -> device (implied {implied[path]}); "
            f"{len(objs)} stitched sources "
            f"({sum(o['merged'] for o in objs)} merged)")
        log(f"mosaic {name} phase_times: {rep.phase_times}; SFinder runtime "
            f"{rep.runtime_s:.4f} s, setup before it (weights, model) "
            f"{wall - rep.runtime_s:.4f} s; read_s {rep.read_s:.4f}, max "
            f"in flight {rep.max_inflight_batches}")
    # the tile-context catalogs of the three paths agree by the catalog rule
    for name in ("auto", "band"):
        why = catalog_mismatch(catalog_arrays(catalogs["off"]),
                               catalog_arrays(catalogs[name]))
        same_names = ([o["name"] for o in catalogs["off"]]
                      == [o["name"] for o in catalogs[name]])
        log(f"mosaic catalogs off vs {name}: catalog rule "
            f"{why or 'ok'}, names equal {same_names}, bit-equal "
            f"{catalogs['off'] == catalogs[name]}")
        require(why is None and same_names,
                f"mosaic {name} catalog differs from the streamed one: {why}")
    log(f"mosaic host -> device bytes: streamed windows "
        f"{runs['off'].report.h2d_bytes}, mosaic {runs['auto'].report.h2d_bytes}"
        f" ({runs['off'].report.h2d_bytes / runs['auto'].report.h2d_bytes:.3f}"
        f"x fewer), bands {runs['band'].report.h2d_bytes}")

    # the serial run on a 640 px crop
    for c in counters.values():
        c.launches = 0
    out_json, out_reg = (os.path.join(tmp, f"serial.{e}") for e in
                         ("json", "reg"))
    from caesar_yolo_tpu_torch.cli import run as cli_run
    t0 = time.perf_counter()
    rc, _ = cli_run.run([*mosaic_cli(tmp), "--xmin=0", "--xmax=639",
                         "--ymin=0", "--ymax=639",
                         f"--detect_outfile_json={out_json}",
                         f"--detect_outfile={out_reg}"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["serial"] = {k: c.launches for k, c in counters.items()}
    require(rc == 0, "mosaic serial run failed")
    expect = {k: 0 for k in counters}
    expect.update(PER_FORWARD)
    log(f"mosaic serial launches: {launches['serial']} (expected {expect})")
    require(launches["serial"] == expect,
            "mosaic serial run did not launch the kernels as expected")
    with open(out_json) as f:
        objs = json.load(f)["objs"]
    with open(out_reg) as f:
        regions = f.read().splitlines()
    boxes = catalog_arrays(objs)[0]
    require(len(objs) > 0 and len(regions) == 2 + len(objs)
            and np.isfinite(boxes).all() and (boxes >= 0).all()
            and (boxes <= 640).all(), "mosaic serial: catalog")
    log(f"mosaic serial: 640x640 crop in {wall:.3f} s, {len(objs)} objects")
    return launches, tps


# ---------------------------------------------------------- multi-process


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_ranks(tmp, name, spec, world, init):
    """Run `spec` on `world` ranks of tests/torch_mp_worker.py, each a
    subprocess with its own timeout, in the directory tmp/mp_<name>; init
    "env" launches them with the launcher's environment (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT) as torchrun does, "file" with a
    file:// rendezvous.  Every rank must exit 0; a rank left running is
    killed.  -> (each rank's result, the launch's wall s)."""
    out = os.path.join(tmp, "mp_" + name)
    os.makedirs(out)
    spec = dict(spec, world=world, out=out, timeout_s=MP_TIMEOUT_S,
                init=(init if init != "file"
                      else f"file://{os.path.join(out, 'rendezvous')}"))
    path = os.path.join(out, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, PYTHONPATH=REPO)
    if init == "env":
        env.update(MASTER_ADDR="localhost", MASTER_PORT=str(free_port()),
                   WORLD_SIZE=str(world))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "torch_mp_worker.py"),
         path, str(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)) if init == "env"
        else env) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=MP_TIMEOUT_S)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    for r, (p, text) in enumerate(zip(procs, logs)):
        require(p.returncode == 0, f"multiproc {name} rank {r} failed "
                f"({p.returncode}):\n{text[-4000:]}")
    results = []
    for r in range(world):
        with open(os.path.join(out, f"{spec['mode']}_rank{r}_n{world}.json")
                  ) as f:
            results.append(json.load(f))
    return results, wall


def train_mismatch(golden_train, ref, got):
    """The golden-train rule (golden_mismatch) on yolo11l's steps, with
    each update norm first moved toward the reference by up to its
    tensor's f32 resolution (sqrt(n) * spacing(max |w|), from the worker):
    at random init yolo11l's BN scales (near 1) move by a few ulps, so the
    rule's 1e-3 is finer than their weights can show, and the one process
    on the same batch in another row order misses the plain rule on 95 of
    513 tensors (scripts/torch_mp_train_noise.py).  Differences past the
    resolution are held to the rule unchanged."""
    diff = got["update_norms"] - ref["update_norms"]
    moved = np.sign(diff) * np.maximum(np.abs(diff) - got["resolution"], 0)
    return golden_train.golden_mismatch(
        ref, dict(got, update_norms=ref["update_norms"] + moved))


def summary_arrays(summary):
    """A worker's golden-train summary (JSON lists) as the f32 arrays
    summarise made (golden_mismatch counts ulps of the final convs)."""
    return {k: np.asarray(v) if k == "norm_keys"
            else np.asarray(v, np.float32) for k, v in summary.items()}


def rank_batches(grid, rank, nproc):
    """Batches of MAIN_BATCH a rank dispatches on the full path: its
    tiles (tid % nproc == rank) by shape."""
    shapes = Counter((x1 - x0, y1 - y0) for tid, (x0, x1, y0, y1)
                     in enumerate(grid) if tid % nproc == rank)
    return sum(-(-n // MAIN_BATCH) for n in shapes.values())


def phase_multiproc(torch, tmp):
    """The tiled CLI and Trainer steps over torch.distributed: two gloo
    ranks sharing the card, one process, one NCCL rank (module
    docstring)."""
    from caesar_yolo_tpu_torch.utils.boxes import catalog_mismatch
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import test_torch_train_golden as golden_train

    torch.cuda.empty_cache()
    grid = mosaic_grid()
    argv = [*mosaic_cli(tmp), *MOSAIC_TILED]
    tiled = {}
    for key, world, backend, init, extra in (
            ("gloo2", 2, "gloo", "env", ["--devices=cuda:0"]),
            ("one", 1, None, None, []),
            ("nccl1", 1, "nccl", "file", [])):
        workdir = os.path.join(tmp, f"mp_catalog_{key}")
        os.makedirs(workdir)
        ranks, wall = launch_ranks(tmp, f"tiled_{key}", dict(
            mode="tiled", backend=backend, workdir=workdir,
            argv=argv + extra), world, init)
        tiled[key] = ranks
        files = sorted(os.listdir(workdir))
        require(files == ["catalog_mosaic.json", "ds9_mosaic.reg"],
                f"multiproc tiled {key}: files {files} (one catalog, one DS9 "
                f"file, no spool)")
        with open(os.path.join(workdir, "catalog_mosaic.json")) as f:
            require(json.load(f)["sources"] == ranks[0]["sources"],
                    f"multiproc tiled {key}: the catalog file is not rank "
                    f"0's")
        for r in ranks:
            require(r["rc"] == 0 and r["n_tiles"] == len(grid),
                    f"multiproc tiled {key} rank {r['rank']}: rc {r['rc']}, "
                    f"{r['n_tiles']} tiles")
            require(r["sources"] == ranks[0]["sources"],
                    f"multiproc tiled {key}: rank {r['rank']}'s catalog "
                    f"differs from rank 0's")
            expect = {k: n * rank_batches(grid, r["rank"], world)
                      for k, n in PER_FORWARD.items()}
            got = {k: r["launches"][k] for k in expect}
            require(got == expect and r["launches"]["epilogue"] > 0,
                    f"multiproc tiled {key} rank {r['rank']}: launches {got},"
                    f" expected {expect} (and K10)")
        runtime = max(r["runtime_s"] for r in ranks)
        log(on_card(
            f"multiproc tiled {key}: {world} rank(s) "
            f"({ranks[0]['backend'] or 'no group'}) on "
            f"{[r['device'] for r in ranks]}, local tiles "
            f"{[r['n_local_tiles'] for r in ranks]}, paths "
            f"{[r['tiling_mode'] for r in ranks]}; launch wall {wall:.3f} s, "
            f"cli.run walls {[round(r['wall_s'], 4) for r in ranks]} s, "
            f"SFinder runtimes {[round(r['runtime_s'], 4) for r in ranks]} "
            f"s = {len(grid) / runtime:.2f} tiles/s by the slowest rank; "
            f"gather rounds {[r['gather_rounds'] for r in ranks]}, bytes "
            f"{[r['gather_bytes'] for r in ranks]}; phase times of rank 0 "
            f"{ranks[0]['phase_times']}; launches {[r['launches'] for r in ranks]}; "
            f"collectives {[r['collectives'] for r in ranks]}"))
    require([r["n_local_tiles"] for r in tiled["gloo2"]] == [50, 50],
            "multiproc tiled: the two ranks must take 50 tiles each")
    require(all(r["gather_rounds"] == 1 for k in ("gloo2", "nccl1")
                for r in tiled[k]) and tiled["one"][0]["gather_rounds"] == 0,
            "multiproc tiled: one gather round under a group, none without")
    require(tiled["nccl1"][0]["backend"] == "nccl"
            and tiled["gloo2"][0]["backend"] == "gloo",
            "multiproc tiled: backends")
    ref = catalog_arrays(tiled["one"][0]["sources"])
    for key in ("gloo2", "nccl1"):
        why = catalog_mismatch(ref, catalog_arrays(tiled[key][0]["sources"]))
        log(f"multiproc tiled {key} vs one process: catalog rule "
            f"{why or 'ok'}, bit-equal "
            f"{tiled[key][0]['sources'] == tiled['one'][0]['sources']}")
        require(why is None, f"multiproc tiled {key}: {why}")

    spec = dict(mode="train", model="yolo11l", seed=0,
                batch=[MP_TRAIN_BATCH, MAIN_SIZE], augment=MP_AUGMENT_SEED,
                steps=MP_TRAIN_STEPS, summary_after=MP_TRAIN_STEPS,
                compute_dtype="float32", bf16_profile=True)
    train = {}
    for key, world, backend, init, device in (
            ("gloo2", 2, "gloo", "env", "cuda:0"),
            ("one", 1, None, None, None),
            ("nccl1", 1, "nccl", "file", None)):
        ranks, wall = launch_ranks(tmp, f"train_{key}", dict(
            spec, backend=backend, device=device), world, init)
        train[key] = ranks
        for r in ranks:
            require(all(r["launches"][k] > 0 for k in
                        ("attn_bwd", "upsample_bwd", "shift", "attn",
                         "upsample")),
                    f"multiproc train {key} rank {r['rank']}: launches "
                    f"{r['launches']}")
        for r in ranks[1:]:
            require(r["params_hash"] == ranks[0]["params_hash"]
                    and r["ema_hash"] == ranks[0]["ema_hash"]
                    and r["losses"] == ranks[0]["losses"],
                    f"multiproc train {key}: rank {r['rank']}'s weights, EMA "
                    f"or losses differ from rank 0's")
        bf16 = [r["bf16"] for r in ranks]
        log(on_card(
            f"multiproc train {key}: {world} rank(s) "
            f"({ranks[0]['backend'] or 'no group'}) on "
            f"{[r['device'] for r in ranks]}, yolo11l@{MAIN_SIZE} f32 "
            f"global batch {MP_TRAIN_BATCH}: losses {ranks[0]['losses']}, "
            f"{MP_TRAIN_STEPS} steps in {[round(r['wall_s'], 4) for r in ranks]}"
            f" s, launch wall {wall:.3f} s; bf16 step "
            f"{[round(b['step_s'], 4) for b in bf16]} s, collectives a step "
            f"{[b['collectives_per_step'] for b in bf16]}, gradient "
            f"all-reduce {[b['grad_all_reduce_s'] for b in bf16]} s (share "
            f"of the step {[b['grad_all_reduce_share'] for b in bf16]}; "
            f"under torch.profiler its span "
            f"{[b['profiled_span_s'] for b in bf16]} s of profiled steps "
            f"{[round(b['profiled_step_s'], 4) for b in bf16]} s), "
            f"{bf16[0]['grad_bytes']} gradient bytes; launches "
            f"{[r['launches'] for r in ranks]}"))
    ref = summary_arrays(train["one"][0]["summary"])
    for key in ("gloo2", "nccl1"):
        got = summary_arrays(train[key][0]["summary"])
        why = train_mismatch(golden_train, ref, got)
        rel = np.abs(got["loss"] - ref["loss"]) / ref["loss"]
        err = np.abs(got["update_norms"] - ref["update_norms"])
        plain = err > golden_train.UPDATE_RTOL * ref["update_norms"] + 1e-9
        log(f"multiproc train {key} vs one process: losses max rel err "
            f"{rel.max():.3g} (limit {golden_train.LOSS_RTOL}); update "
            f"norms of {len(err)} tensors, {int(plain.sum())} past "
            f"{golden_train.UPDATE_RTOL} relative, max "
            f"{(err / (golden_train.UPDATE_RTOL * ref['update_norms'] + 1e-9 + got['resolution'])).max():.3g} "
            f"of the limit with the weights' resolution -> {why or 'ok'}")
        require(why is None, f"multiproc train {key}: {why}")
    require(train["nccl1"][0]["backend"] == "nccl"
            and train["gloo2"][0]["backend"] == "gloo",
            "multiproc train: backends")
    # the golden batch on two gloo ranks against the JAX Trainer's numbers
    # on the whole batch, by the golden-train rule as it stands
    ranks, _ = launch_ranks(tmp, "golden_train", dict(
        mode="train", backend="gloo", device="cuda:0",
        weights=os.path.join(REPO, "tests", "fixtures", "yolov8n_synth96.npz"),
        batch="golden", steps=golden_train.STEPS,
        summary_after=golden_train.STEPS, compute_dtype="float32"), 2, "env")
    got = summary_arrays(ranks[0]["summary"])
    golden = golden_train.load_golden()
    why = golden_train.golden_mismatch(golden, got)
    nz = golden["update_norms"] > 0
    urel = (np.abs(got["update_norms"] - golden["update_norms"])[nz]
            / golden["update_norms"][nz])
    log(f"multiproc golden-train on two gloo ranks (yolov8n_synth96 @96 f32, "
        f"2 + 2 of the batch): losses {got['loss'].tolist()} vs JAX "
        f"{golden['loss'].tolist()}, update norms max rel err "
        f"{urel.max():.3g} (limit {golden_train.UPDATE_RTOL}) -> "
        f"{why or 'ok'}")
    require(why is None and ranks[0]["params_hash"] == ranks[1]["params_hash"],
            f"multiproc golden-train: {why or 'ranks differ'}")


# --------------------------------------------------------- .pt and PNG input

ULTRA_MODULES = ("chip_smoke_ultralytics", "chip_smoke_ultralytics.nn",
                 "chip_smoke_ultralytics.nn.tasks")
BN_LEAVES = {"gamma": "bn.weight", "beta": "bn.bias",
             "mean": "bn.running_mean", "var": "bn.running_var"}


def ultralytics_state(model):
    """The port's YOLO weights under an ultralytics checkpoint's keys
    (model.<yaml row>..., conv/bn leaves by ultralytics' names, the Detect
    head at the last row: cv2 the box branch, cv3 the class branch, whose
    v11 (DWConv, Conv) pairs are cv3.L.0.{0,1} and cv3.L.1.{0,1})."""
    row = {name: i for i, (name, _) in enumerate(model.graph)}
    state = model.state_dict()
    out = {}
    for key, t in state.items():
        *path, leaf = key.split(".")
        if path[-1] == "bn":
            path, tail = path[:-1], BN_LEAVES[leaf]
        elif leaf == "w" and ".".join(path + ["b"]) not in state:
            tail = "conv.weight"
        else:
            tail = {"w": "weight", "b": "bias"}[leaf]
        if path[0] == "head":
            _, branch, lvl, j = path
            j = int(j)
            if branch == "box":
                mod = f"cv2.{lvl}.{j}"
            elif len(model.head.cls[int(lvl)]) == 3:
                mod = f"cv3.{lvl}.{j}"
            else:
                mod = f"cv3.{lvl}.{j // 2}.{j % 2}" if j < 4 else f"cv3.{lvl}.2"
            parts = [f"model.{len(model.graph)}", mod]
        else:
            parts = [f"model.{row[path[0]]}",
                     *({"ffn1": "ffn.0", "ffn2": "ffn.1"}.get(p, p)
                       for p in path[1:])]
        out[".".join([*parts, tail])] = t.detach().float().cpu().clone()
    return out


def save_ultralytics_pt(torch, path, state, epoch=0):
    """Pickle `state` ({ultralytics key: tensor}) as ultralytics saves a
    checkpoint, {"model": m, "ema": m, "epoch": ...}, with m a module tree
    whose classes live in a module that is gone once the file is written
    (so a reader must resolve them without it)."""
    import types

    from torch import nn

    class Node(nn.Module):
        pass

    class DetectionModel(nn.Module):
        pass

    mods = [types.ModuleType(n) for n in ULTRA_MODULES]
    for cls in (Node, DetectionModel):
        cls.__module__ = ULTRA_MODULES[-1]
        cls.__qualname__ = cls.__name__
        setattr(mods[-1], cls.__name__, cls)
    for parent, child in zip(mods, mods[1:]):
        setattr(parent, child.__name__.rsplit(".", 1)[1], child)
    sys.modules.update(zip(ULTRA_MODULES, mods))
    try:
        root = DetectionModel()
        for key, t in state.items():
            *parts, leaf = key.split(".")
            node = root
            for part in parts:
                if part not in node._modules:
                    node.add_module(part, Node())
                node = node._modules[part]
            if leaf.startswith("running_") or not t.is_floating_point():
                node.register_buffer(leaf, t.clone())
            else:
                node.register_parameter(leaf, nn.Parameter(t.clone(), False))
        torch.save({"model": root, "ema": root, "epoch": epoch}, path)
    finally:
        for name in ULTRA_MODULES:
            del sys.modules[name]


def write_png(path, samples, color_type):
    """samples [H, W, C] uint8 or uint16 -> a PNG file of that colour type
    (0 grey, 2 RGB), every row filtered with Sub, by the standard library's
    zlib and struct."""
    import struct
    import zlib
    h, w, c = samples.shape
    depth = 16 if samples.dtype == np.uint16 else 8
    raw = np.ascontiguousarray(samples.astype(">u2" if depth == 16
                                              else np.uint8)
                               ).reshape(h, -1).view(np.uint8)
    bpp = c * depth // 8
    sub = raw.copy()
    sub[:, bpp:] = raw[:, bpp:] - raw[:, :-bpp]
    body = np.concatenate([np.ones((h, 1), np.uint8), sub], axis=1).tobytes()

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                             color_type, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(body, 6)) + chunk(b"IEND", b""))


def readme_launches(counters):
    """The launches of one serial forward with the README chain."""
    expect = {k: 0 for k in counters}
    expect.update(nms=1, attn=2, upsample=2, preproc=1)
    return expect


def serial_cli(torch, counters, flags, what):
    """cli.run serially with `flags`; its launches must be one README-chain
    forward's.  Returns (the JSON catalog, wall s)."""
    from caesar_yolo_tpu_torch.cli import run as cli_run
    out = next(f.split("=", 1)[1] for f in flags
               if f.startswith("--detect_outfile_json="))
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    rc, _ = cli_run.run(flags)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    require(rc == 0, f"{what}: cli.run failed")
    log(f"{what} launches: {launches}")
    require(launches == readme_launches(counters),
            f"{what} did not launch K1, K2 and K3 as expected")
    with open(out) as f:
        return json.load(f), wall


DIRECT_MODELS = ("yolo11l", "yolov8l", "yolo12l")
SETUP_SPANS = ("cli.load_weights", "cli.build", "cli.preprocessor",
               "sfinder.header", "engine.prepare")
DIRECT_SPANS = ("weights.read", "weights.upload", "weights.fold")


def seeded_model(torch, name, seed, nc=5):
    """`name` at `nc` classes with init_weights' kernels and BatchNorm
    statistics and layer scales drawn from `seed` (init_weights leaves BN
    at identity, which would fold to nothing)."""
    from caesar_yolo_tpu_torch.models.yolo import build_model, init_weights

    model = init_weights(build_model(name, num_classes=nc), seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for key, t in model.state_dict().items():
            low, high = ((0.05, 2.0) if key.endswith(".bn.var") else
                         (-0.5, 0.5) if key.endswith((".bn.beta",
                                                      ".bn.mean"))
                         else (0.5, 1.5) if key.endswith("gamma")
                         else (None, None))
            if low is not None:
                t.copy_(torch.rand(t.shape, generator=gen) * (high - low)
                        + low)
    return model


def save_hwio_npz(model, path, meta):
    """The weights as the benchmark's reference/weights.py:save_npz writes
    them: np.savez of the leaves with 4-D kernels transposed OIHW -> HWIO
    as they lie (np.save keeps a 1x1 kernel's transpose column-major)."""
    flat = {}
    for key, t in model.state_dict().items():
        a = t.detach().float().cpu().numpy()
        if a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)
        flat[key.replace(".", "/")] = a
    flat["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(path, **flat)
    return path


def prepared_mismatch(torch, a, b):
    """Where two inference models differ -> [] or the first differences:
    their modules' names and types, every parameter and buffer by name,
    dtype, shape, strides, device, requires_grad and bits, the compute
    dtype and the mode."""
    # floats compared as integers of their width: bit for bit
    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    out = []
    if [(n, type(m)) for n, m in a.named_modules()] != \
            [(n, type(m)) for n, m in b.named_modules()]:
        out.append("module trees differ")
    for kind in ("named_parameters", "named_buffers"):
        ta, tb = list(getattr(a, kind)()), list(getattr(b, kind)())
        if [n for n, _ in ta] != [n for n, _ in tb]:
            out.append(f"{kind}: names differ")
            continue
        for (name, x), (_, y) in zip(ta, tb):
            if (x.dtype, x.shape, x.stride(), x.device, x.requires_grad) != (
                    y.dtype, y.shape, y.stride(), y.device, y.requires_grad):
                out.append(f"{name}: {x.dtype} {tuple(x.shape)} "
                           f"{x.stride()} {x.device} against {y.dtype} "
                           f"{tuple(y.shape)} {y.stride()} {y.device}")
            elif not torch.equal(*(t.view(bits.get(t.dtype, t.dtype))
                                   for t in (x, y))):
                out.append(f"{name}: values differ")
    if (a.compute_dtype, a.training) != (b.compute_dtype, b.training):
        out.append("compute dtype or mode differ")
    return out[:5]


def direct_and_copied(torch, path, name, device):
    """The inference model of the npz at `path` by the direct route
    (read_npz, build_prepared) and by prepare_model's copy of load_model's
    f32 model -> (direct, copied)."""
    from caesar_yolo_tpu_torch.detect.predictor import prepare_model
    from caesar_yolo_tpu_torch.models.convert import (build_prepared,
                                                      load_model, read_npz)

    weights = read_npz(path, pin=device.type == "cuda")
    direct = build_prepared(weights, name, 5, dtype=torch.bfloat16,
                            device=device)
    copied = prepare_model(load_model(path)[0], dtype=torch.bfloat16,
                           device=device)
    return direct, copied


def phase_weights(torch, tmp):
    """The direct route from an npz to the engine's model (models/
    convert.py: read_npz, build_prepared) on the card: for yolo11l,
    yolov8l and yolo12l at 5 classes, seeded weights written as the
    benchmark writes them, the model bit-equal to prepare_model's copy of
    load_model's (every parameter by name, dtype, shape and strides).
    Then one tiled field of yolo11l (2560 px mosaic, 512 px tiles at step
    0.5, README chain) by cli.run, and by the copy route as cli.run took
    it before (load_model_from_args, an SFinder that copies the model), in
    turns after one warm field each: the five set-up spans, and the direct
    route's three on that route alone, whose engine runs cli.run's model
    itself."""
    from caesar_yolo_tpu_torch.cli import run as cli_run
    from caesar_yolo_tpu_torch.cli.preproc_args import (
        build_preprocessor_from_args)
    from caesar_yolo_tpu_torch.parallel.sfinder import SFinder
    from caesar_yolo_tpu_torch.utils.synth import write_mosaic_fits
    from caesar_yolo_tpu_torch.utils.trace import Recorder

    dev = torch.device(DEVICE)
    for k, name in enumerate(DIRECT_MODELS):
        path = save_hwio_npz(seeded_model(torch, name, 7 + k),
                             os.path.join(tmp, f"direct_{name}.npz"),
                             {"model": name, "num_classes": 5})
        direct, copied = direct_and_copied(torch, path, name, dev)
        why = prepared_mismatch(torch, direct, copied)
        n = sum(1 for _ in direct.parameters())
        log(f"weights: {name} direct route against prepare_model on the "
            f"card: {n} parameters, {os.path.getsize(path)} bytes of npz, "
            f"bit-equal {not why} {why}")
        require(not why, f"weights: {name} direct model differs: {why}")
        del direct, copied
    field = os.path.join(tmp, "direct_field.fits")
    write_mosaic_fits(field, MOSAIC_SIZE, MOSAIC_SIZE, n_sources=400,
                      seed=11)
    weights = os.path.join(tmp, f"direct_{DIRECT_MODELS[0]}.npz")
    argv = [f"--image={field}", f"--weights={weights}",
            "--split_img_in_tiles", f"--tile_xsize={MOSAIC_TILE}",
            f"--tile_ysize={MOSAIC_TILE}", "--tile_xstep=0.5",
            "--tile_ystep=0.5", "--batch_size=32", "--scoreThr=0.7",
            *README_CHAIN, f"--devices={DEVICE}",
            f"--detect_outfile_json={tmp}/direct.json",
            f"--detect_outfile={tmp}/direct.reg"]

    def copy_route():
        args = cli_run.parse_args(argv)
        rec = Recorder()
        model = cli_run.load_model_from_args(args, rec)
        with rec.span("cli.preprocessor"):
            preproc = build_preprocessor_from_args(args)
        sf = SFinder(model, cli_run.config_from_args(args),
                     preprocessor=preproc, device=DEVICE, recorder=rec)
        return sf.run_tiled(), sf

    routes = {"direct": lambda: cli_run.run(argv), "copy": copy_route}
    order = ("direct", "copy") * 3 + ("copy", "direct")
    for turn, name in enumerate(order):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc, sf = routes[name]()
        wall = time.perf_counter() - t0
        require(rc == 0, f"weights: {name} field failed")
        ph = sf.report.phase_times
        setup = sum(ph.get(k, 0.0) for k in SETUP_SPANS)
        log(f"weights: field {turn} {name} route ({sf.report.n_tiles} "
            f"tiles): wall {wall:.4f} s, set-up spans {setup:.4f} s: " +
            ", ".join(f"{k} {ph[k]:.4f}" for k in SETUP_SPANS +
                      DIRECT_SPANS if k in ph))
        require(all((k in ph) == (name == "direct") for k in DIRECT_SPANS),
                "weights: the direct route's spans on the wrong route")
        require((sf._engine.model is sf.model) == (name == "direct"),
                "weights: the engine copied the direct model, or ran the "
                "copy route's own")


def phase_pt(torch, counters, tmp):
    """The main phase's seeded yolo11l as an ultralytics checkpoint
    (written by this script, its classes gone at load time): cli.convert's
    npz leaves must be bit-equal to save_params of the model, and cli.run
    serially on the mosaic's 640x640 crop (README chain, bf16) must write
    the same catalog from the .pt as from the npz."""
    from caesar_yolo_tpu_torch.cli import convert as cli_convert
    from caesar_yolo_tpu_torch.detect.predictor import Predictor
    from caesar_yolo_tpu_torch.models.convert import (convert_checkpoint,
                                                      load_model)
    from caesar_yolo_tpu_torch.models.yolo import build_model, init_weights
    from caesar_yolo_tpu_torch.utils.fits import read_fits_crop

    model = init_weights(build_model("yolo11l"), seed=0)
    pt = os.path.join(tmp, "yolo11l.pt")
    npz = os.path.join(tmp, "yolo11l_seed0.npz")   # the mosaic phase's
    save_ultralytics_pt(torch, pt, ultralytics_state(model), epoch=300)
    converted = os.path.join(tmp, "converted.npz")
    t0 = time.perf_counter()
    require(cli_convert.main([pt, converted]) == 0, "cli.convert failed")
    convert_s = time.perf_counter() - t0
    with np.load(npz) as ref, np.load(converted) as got:
        same = (sorted(ref.files) == sorted(got.files)
                and all(ref[k].dtype == got[k].dtype
                        and np.array_equal(ref[k], got[k])
                        for k in ref.files))
        n_leaves = len(ref.files) - 1
    log(f"pt: cli.convert {os.path.getsize(pt)} bytes -> npz of {n_leaves} "
        f"leaves in {convert_s:.3f} s; leaves and meta bit-equal to "
        f"save_params: {same}")
    require(same, "cli.convert's npz differs from save_params of the model")
    t0 = time.perf_counter()
    from_pt = convert_checkpoint(pt)[0]
    pt_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    from_npz = load_model(npz)[0]
    npz_s = time.perf_counter() - t0
    log(f"pt: yolo11l .pt load and convert {pt_s:.4f} s, npz load "
        f"{npz_s:.4f} s (both to a model on the CPU in f32)")
    # every slot of the raw detections, before merge, on the crop
    tile = read_fits_crop(os.path.join(tmp, "mosaic.fits"), 0, 640, 0,
                          640)[0]
    tile = np.repeat(np.nan_to_num(tile)[:, :, None], 3, axis=-1)
    raw = [[t.cpu() for t in Predictor(m, img_size=MAIN_SIZE,
                                       score_thr=MOSAIC_SCORE_THR,
                                       pre_nms=PRE_NMS).predict_batch(tile)]
           for m in (from_pt, from_npz)]
    same = all(torch.equal(a, b) for a, b in zip(*raw))
    log(f"pt: raw detections of the two models on the crop ({MAIN_SIZE} "
        f"px, bf16): {int(raw[1][3].sum())} valid of {raw[1][3].numel()} "
        f"slots, every slot bit-equal {same}")
    require(same, "the .pt and npz models detect differently")
    crop = [f"--image={os.path.join(tmp, 'mosaic.fits')}", "--xmin=0",
            "--xmax=639", "--ymin=0", "--ymax=639",
            f"--scoreThr={MOSAIC_SCORE_THR}", *README_CHAIN]
    cats, walls = {}, {}
    for name, weights in (("pt", pt), ("npz", npz)):
        cats[name], walls[name] = serial_cli(
            torch, counters,
            [*crop, f"--weights={weights}",
             f"--detect_outfile_json={os.path.join(tmp, f'w_{name}.json')}",
             f"--detect_outfile={os.path.join(tmp, f'w_{name}.reg')}"],
            f"pt: cli.run --weights=yolo11l.{name}")
    log(f"pt: serial 640x640 crop, README chain, bf16: {len(cats['pt']['objs'])}"
        f" objects from the .pt in {walls['pt']:.3f} s, "
        f"{len(cats['npz']['objs'])} from the npz in {walls['npz']:.3f} s; "
        f"catalogs identical {cats['pt'] == cats['npz']}")
    require(len(cats["npz"]["objs"]) > 0 and cats["pt"] == cats["npz"],
            "the .pt and npz catalogs differ")


def phase_image(torch, counters, tmp):
    """PNG and JPEG input: the mosaic's 640x640 crop as an 8-bit RGB PNG
    and a 16-bit grey PNG (this script's encoder) read back exactly; the
    serial cli.run on each equal to Analyzer.predict on the same array;
    cli.evaluate on 32 labelled 132 px PNG cutouts (K3 once a batch);
    JPEG through Pillow where it imports, else its clear refusal."""
    from caesar_yolo_tpu_torch.cli import evaluate as cli_evaluate
    from caesar_yolo_tpu_torch.cli import run as cli_run
    from caesar_yolo_tpu_torch.cli.preproc_args import (
        build_preprocessor_from_args)
    from caesar_yolo_tpu_torch.detect.analyzer import (Analyzer,
                                                       AnalyzerOutputs)
    from caesar_yolo_tpu_torch.detect.predictor import Predictor
    from caesar_yolo_tpu_torch.models.convert import load_model
    from caesar_yolo_tpu_torch.utils.fits import (read_fits, read_fits_crop,
                                                  read_image)
    from caesar_yolo_tpu_torch.utils.synth import write_labelled_cutouts

    def quantise(x, top):
        x = np.nan_to_num(np.asarray(x, np.float64))
        span = float(x.max() - x.min()) or 1.0
        return np.round((x - x.min()) / span * top)

    npz = os.path.join(tmp, "yolo11l_seed0.npz")
    crop = read_fits_crop(os.path.join(tmp, "mosaic.fits"), 0, 640, 0,
                          640)[0]
    q16 = quantise(crop, 65535).astype(np.uint16)
    q8 = (q16 >> 8).astype(np.uint8)
    rgb = np.stack([q8, (q8.astype(np.uint16) * 3 // 4).astype(np.uint8),
                    q8 // 2], axis=-1)
    pngs = {"rgb8": (rgb, 2, 255), "grey16": (q16[:, :, None], 0, 65535)}
    model = load_model(npz)[0]
    for name, (samples, ctype, top) in pngs.items():
        path = os.path.join(tmp, f"crop_{name}.png")
        write_png(path, samples, ctype)
        data, header = read_image(path)
        want = np.divide(samples, top, dtype=np.float32)
        want = want[:, :, 0] if ctype == 0 else want
        exact = (header is None and data.dtype == np.float32
                 and np.array_equal(data, want))
        log(f"image: {name} PNG {os.path.getsize(path)} bytes read back "
            f"{data.shape} {data.dtype}, equal to the written values / "
            f"{top}: {exact}")
        require(exact, f"read_image of the {name} PNG differs")
        flags = [f"--image={path}", f"--weights={npz}",
                 f"--scoreThr={MOSAIC_SCORE_THR}", *README_CHAIN,
                 f"--detect_outfile_json={path}.json",
                 f"--detect_outfile={path}.reg"]
        got, wall = serial_cli(torch, counters, flags,
                               f"image: cli.run on the {name} PNG")
        args = cli_run.parse_args(flags)
        cfg = cli_run.config_from_args(args)
        analyzer = Analyzer(
            Predictor(model, img_size=cfg.img_size, score_thr=cfg.score_thr,
                      iou_thr=cfg.iou_thr, pre_nms=cfg.pre_nms),
            preprocessor=build_preprocessor_from_args(args),
            soft_merge_thr=cfg.merge_overlap_iou_thr_soft,
            hard_merge_thr=cfg.merge_overlap_iou_thr_hard,
            outputs=AnalyzerOutputs(outfile_json=f"{path}.ref.json",
                                    outfile_ds9=f"{path}.ref.reg"),
            class_names=cfg.class_names)
        require(analyzer.predict(data, f"crop_{name}") == 0,
                f"Analyzer.predict on the {name} PNG failed")
        with open(f"{path}.ref.json") as f:
            ref = json.load(f)
        log(f"image: {name} PNG serial run {wall:.3f} s, "
            f"{len(got['objs'])} objects; equal to Analyzer.predict on the "
            f"read array: {got == ref}")
        require(len(ref["objs"]) > 0 and got == ref,
                f"the {name} PNG catalog differs from Analyzer.predict's")

    # cli.evaluate on labelled PNG cutouts
    root = os.path.join(tmp, "png_cutouts")
    fits_paths = write_labelled_cutouts(root, MAIN_BATCH,
                                        sizes=(TRAIN_CUTOUT,), seed=500)
    paths = []
    for p in fits_paths:
        q = quantise(read_fits(p)[0], 255).astype(np.uint8)
        paths.append(os.path.splitext(p)[0] + ".png")
        write_png(paths[-1], q[:, :, None], 0)
    filelist = os.path.join(root, "png_list.txt")
    with open(filelist, "w") as f:
        f.write("\n".join(paths) + "\n")
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    rc, report = cli_evaluate.run([f"--weights={npz}",
                                   f"--filelist={filelist}", *README_CHAIN,
                                   f"--batch_size={MAIN_BATCH}"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    log(f"image: cli.evaluate on {len(paths)} PNG cutouts of "
        f"{TRAIN_CUTOUT} px: {wall:.3f} s = {len(paths) / wall:.2f} "
        f"images/s (yolo11l@640 bf16, batch {MAIN_BATCH}, README chain), "
        f"launches {launches}")
    require(rc == 0 and launches["preproc"] == 1 and launches["nms"] == 1,
            "cli.evaluate on PNG did not run one K3 and K1 launch a batch")

    # JPEG: through Pillow where it imports, else refused by name
    jpg = os.path.join(tmp, "crop.jpg")
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is None:
        with open(jpg, "wb") as f:
            f.write(b"\xff\xd8\xff\xd9")
        try:
            read_image(jpg)
            refused = ""
        except ImportError as e:
            refused = str(e)
        log(f"image: JPEG without Pillow refused: {refused!r}")
        require("Pillow" in refused, "JPEG without Pillow was not refused "
                "by name")
    else:
        Image.fromarray(rgb).save(jpg, quality=95)
        got, wall = serial_cli(
            torch, counters,
            [f"--image={jpg}", f"--weights={npz}",
             f"--scoreThr={MOSAIC_SCORE_THR}", *README_CHAIN,
             f"--detect_outfile_json={jpg}.json",
             f"--detect_outfile={jpg}.reg"], "image: cli.run on the JPEG")
        log(f"image: JPEG through Pillow, {len(got['objs'])} objects in "
            f"{wall:.3f} s")


def phase_profile(torch, tmp):
    """One "auto" tiled run of the mosaic with --profile_dir: the trace must
    hold events; the device's busy share of the run from its kernels."""
    prof = os.path.join(tmp, "prof")
    flags = [*mosaic_cli(tmp), *MOSAIC_TILED, f"--profile_dir={prof}",
             f"--detect_outfile_json={os.path.join(tmp, 'prof.json')}",
             f"--detect_outfile={os.path.join(tmp, 'prof.reg')}"]
    rc, sf, wall = run_tiled(torch, flags, False)
    require(rc == 0, "profiled mosaic run failed")
    trace = os.path.join(prof, "mosaic.trace.json")
    size = os.path.getsize(trace)
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    require(len(events) > 0, "the profiler trace is empty")
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy",
                                                    "gpu_memset")]
    busy_us = sum(e.get("dur", 0) for e in device)
    run_s = sf.report.runtime_s
    log(f"profile: {trace} ({size} bytes, {len(events)} events, "
        f"{len(device)} device kernels and copies); device busy "
        f"{busy_us / 1e3:.3f} ms of the run's {run_s * 1e3:.3f} ms "
        f"(idle share {1 - busy_us / 1e6 / run_s:.4f}; profiler on, wall "
        f"{wall:.3f} s)")


def phase_resume(torch, tmp):
    """scripts/torch_drill_banded_resume.py's A/B/C at the mosaic phase's
    size: the tiled CLI's configuration as subprocesses on the banded path,
    B SIGKILLed once its spool holds a grid row of tiles, C resumed from
    B's spool; C's catalog must be A's, bit for bit."""
    drill = script("torch_drill_banded_resume")
    flags = [*mosaic_cli(tmp), *MOSAIC_TILED]
    summary = drill.drill(os.path.join(tmp, "drill"), flags,
                          kill_after=MOSAIC_SIZE * 2 // MOSAIC_TILE,
                          timeout=300)
    log(f"resume drill: {json.dumps(summary)}")
    require(summary["mode"].startswith("band"), "drill did not take bands")
    require(summary["resumed_tiles_C"] == summary[
        "killed_with_spooled_tiles"] > 0, "drill resumed no spooled tile")
    require(summary["catalog_identical_after_resume"],
            "the resumed catalog differs from the uninterrupted one")
    log(f"resume: {summary['resumed_tiles_C']} tiles resumed from the "
        f"killed run's spool, {summary['recomputed_tiles_C']} recomputed; "
        f"catalog identical to the uninterrupted run's")


def phase_eval(torch, counters, tmp, card):
    """Dataset evaluation and datalist detection with yolo11l@640 bf16 on
    96 labelled cutouts: cli.evaluate (README preprocessing, K3),
    evaluate_dataset with the CLAHE Pipeline (K7) and cli.run --datalist
    (batched route).  Returns each run's launches."""
    from caesar_yolo_tpu_torch.cli import evaluate as cli_evaluate
    from caesar_yolo_tpu_torch.cli import run as cli_run
    from caesar_yolo_tpu_torch.evaluation import evaluate_dataset
    from caesar_yolo_tpu_torch.models.convert import load_model
    from caesar_yolo_tpu_torch.ops.transforms import Pipeline, hist_equalizer

    root = os.path.join(tmp, "evalset")
    filelist = write_cutouts(root, EVAL_IMAGES, seed=5000)
    labels = os.path.join(root, "labels")
    n_gt = 0
    for name in os.listdir(labels):
        with open(os.path.join(labels, name)) as f:
            n_gt += sum(1 for line in f if line.strip())
    weights = os.path.join(tmp, "yolo11l_seed0.npz")
    readme = ["--preprocessing", "--zscale_stretch", "--normalize_minmax"]
    common = [f"--weights={weights}", f"--imgsize={MAIN_SIZE}",
              f"--scoreThr={MOSAIC_SCORE_THR}", f"--batch_size={MAIN_BATCH}"]
    out_dir = os.path.join(tmp, "datalist_out")
    os.makedirs(out_dir)

    def api_clahe():
        model, _ = load_model(weights)
        return 0, evaluate_dataset(
            model, filelist, img_size=MAIN_SIZE, score_thr=MOSAIC_SCORE_THR,
            batch_size=MAIN_BATCH,
            preprocessor=Pipeline([hist_equalizer(adaptive=True)]))

    def datalist():
        cwd = os.getcwd()
        os.chdir(out_dir)       # the batched route writes out_<stem>.*
        try:
            return cli_run.run([f"--datalist={filelist}", *common, *readme])
        finally:
            os.chdir(cwd)

    runs = {"cli.evaluate": (lambda: cli_evaluate.run(
                [f"--filelist={filelist}", *common, *readme]), ("preproc",)),
            "evaluate_dataset+CLAHE": (api_clahe, CLAHE),
            "cli.run --datalist": (datalist, ("preproc",))}
    batches = -(-EVAL_IMAGES // MAIN_BATCH)
    launches = {}
    for name, (fn, stages) in runs.items():
        for c in counters.values():
            c.launches = 0
        clusters = counters["clahe"].cluster_launches
        t0 = time.perf_counter()
        rc, report = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[name] = {k: c.launches for k, c in counters.items()}
        clusters = counters["clahe"].cluster_launches - clusters
        require(clusters == (batches if "clahe" in stages else 0),
                f"eval {name}: {clusters} K7 cluster launches, expected one "
                f"a batch of a CLAHE run")
        require(rc == 0, f"eval {name} failed")
        expect = {k: 0 for k in counters}
        expect.update({k: batches * n for k, n in PER_FORWARD.items()
                       if k in ("nms", "attn", "upsample")})
        expect.update({k: batches for k in stages})
        log(f"eval {name} launches: {launches[name]} (expected {expect} "
            f"over {batches} batches)")
        require(launches[name] == expect,
                f"eval {name} did not launch the kernels as expected")
        if report is not None:
            # per class ("source" sums the source classes)
            n_lab, n_det, n_hit = (sum(
                getattr(c, attr) for k, c in counts.items() if k != "source")
                for counts, attr in ((report.completeness, "n"),
                                     (report.reliability, "n"),
                                     (report.completeness, "n_matched")))
            require(n_lab == n_gt and n_det > 0
                    and np.isfinite(report.map.map50_95),
                    f"eval {name}: {n_lab}/{n_gt} labels, {n_det} "
                    f"predictions, mAP50-95 {report.map.map50_95}")
            what = (f"{n_det} merged detections, {n_hit}/{n_lab} labelled "
                    f"objects matched, mAP50-95 {report.map.map50_95:.4g}")
        else:
            outs = sorted(os.listdir(out_dir))
            n_obj = 0
            for i in range(EVAL_IMAGES):
                with open(os.path.join(out_dir, f"out_c{i:03d}.json")) as f:
                    objs = json.load(f)["objs"]
                boxes = catalog_arrays(objs)[0]
                require(np.isfinite(boxes).all() and (boxes >= 0).all()
                        and (boxes <= TRAIN_CUTOUT).all(),
                        f"datalist out_c{i:03d}.json boxes")
                n_obj += len(objs)
            require(len(outs) == 2 * EVAL_IMAGES,
                    f"datalist wrote {len(outs)} files")
            what = f"{n_obj} objects in {len(outs)} out_<stem>.json/.reg files"
        log(f"eval {name} ({card}): {EVAL_IMAGES} cutouts of {TRAIN_CUTOUT} "
            f"px, yolo11l@{MAIN_SIZE} bf16, batch {MAIN_BATCH}: {wall:.3f} s "
            f"from the call to the report = {EVAL_IMAGES / wall:.2f} "
            f"images/s; {what}")
    return launches


class plain_upsample:
    """Context manager: the model's Upsample takes the plain broadcast
    form (the serving path before K4) instead of the kernel."""

    def __enter__(self):
        from caesar_yolo_tpu_torch.ops import cuda_upsample
        self.mod, self.prev = cuda_upsample, cuda_upsample.upsample2x
        cuda_upsample.upsample2x = cuda_upsample.upsample2x_plain

    def __exit__(self, *exc):
        self.mod.upsample2x = self.prev
        return False


def staged_tps(torch, engine, staged):
    # two warm batches: a shape's first runs eagerly, its second is
    # captured as the engine's CUDA graph, so that no capture is timed
    for st in staged[:2]:
        engine.process_async(st)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for st in staged:
        engine.process_async(st)
    torch.cuda.synchronize()
    return len(staged) * MAIN_BATCH / (time.perf_counter() - t0)


def phase_upsample_ab(torch, engine, model, batches, tmp):
    """Main-path staged tiles/s and mosaic tiled tiles/s with the plain
    broadcast upsample and with K4, in turns: plain, K4, K4, plain.  The
    engine's graphs are dropped as each leg starts (a replay runs the
    upsample it was captured with), and K4's launch counter must move in
    the K4 legs alone."""
    from caesar_yolo_tpu_torch.cli import run as cli_run
    from caesar_yolo_tpu_torch.ops import cuda_upsample

    staged = [engine.put_tiles(bt) for bt in batches]
    common = [*mosaic_cli(tmp), *MOSAIC_TILED,
              f"--detect_outfile_json={os.path.join(tmp, 'ab.json')}",
              f"--detect_outfile={os.path.join(tmp, 'ab.reg')}"]
    out = {"plain": {"main": [], "mosaic": []}, "k4": {"main": [],
                                                       "mosaic": []}}
    for variant in ("plain", "k4", "k4", "plain"):
        ctx = plain_upsample() if variant == "plain" else nullcontext()
        with ctx:
            engine.update_params(model)
            n0 = cuda_upsample.upsample2x_forward.launches
            out[variant]["main"].append(staged_tps(torch, engine, staged))
            t0 = time.perf_counter()
            rc, sf = cli_run.run(common)
            torch.cuda.synchronize()
            require(rc == 0, "mosaic A/B run failed")
            out[variant]["mosaic"].append(
                sf.report.n_tiles / (time.perf_counter() - t0))
            moved = cuda_upsample.upsample2x_forward.launches - n0
        require((moved > 0) == (variant == "k4"),
                f"upsample A/B: the {variant} leg launched K4 {moved} times")
    engine.update_params(model)
    for variant, r in out.items():
        log(f"upsample A/B {variant}: main path staged tiles/s "
            f"{[round(x, 1) for x in r['main']]}, mosaic tiled tiles/s "
            f"{[round(x, 2) for x in r['mosaic']]}")


class transpose_yshear:
    """Context manager: augment_batch's y-shear takes a transposed copy of
    the canvas and the row route (the design before the column route)."""

    def __enter__(self):
        from caesar_yolo_tpu_torch.ops import cuda_shift
        from caesar_yolo_tpu_torch.train import augment
        self.mod, self.prev = augment, augment.fractional_row_shift_batch
        augment.fractional_row_shift_batch = (
            lambda imgs, *a: cuda_shift.fractional_row_shift_batch(
                imgs.contiguous(), *a))

    def __exit__(self, *exc):
        self.mod.fractional_row_shift_batch = self.prev
        return False


def phase_shear_ab(torch, card):
    """augment_batch ms at the training batch (16 images of 640 px) with
    the y-shear as a transposed copy and a row launch and on the column
    route, in turns (transpose, column, column, transpose); both routes
    must give the same bits."""
    from caesar_yolo_tpu_torch.train.augment import (augment_batch,
                                                     draw_augment_params)
    g = torch.Generator(device="cuda").manual_seed(7)
    imgs = torch.rand(TRAIN_BATCH, MAIN_SIZE, MAIN_SIZE, 3, device="cuda",
                      generator=g)
    boxes = torch.tensor([[[100.0, 100.0, 220.0, 180.0]]]).repeat(
        TRAIN_BATCH, 1, 1)
    masks = torch.ones(TRAIN_BATCH, 1, dtype=torch.bool)
    draws = draw_augment_params(torch.Generator().manual_seed(0), TRAIN_BATCH)
    ms, first = {"transpose": [], "column": []}, {}
    for variant in ("transpose", "column", "column", "transpose"):
        with transpose_yshear() if variant == "transpose" else nullcontext():
            first.setdefault(variant, augment_batch(imgs, boxes, masks,
                                                    *draws))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(AB_AUGMENTS):
                augment_batch(imgs, boxes, masks, *draws)
            torch.cuda.synchronize()
            ms[variant].append((time.perf_counter() - t0) * 1e3 / AB_AUGMENTS)
    same = all(torch.equal(a, b) for a, b in zip(first["transpose"],
                                                 first["column"]))
    log(f"y-shear A/B ({card}): augment_batch [{TRAIN_BATCH}, {MAIN_SIZE}, "
        f"{MAIN_SIZE}, 3] ms, mean of {AB_AUGMENTS}: transpose copy + row "
        f"route {[round(x, 3) for x in ms['transpose']]}, column route "
        f"{[round(x, 3) for x in ms['column']]}; same bits {same}")
    require(same, "augment_batch differs between the y-shear routes")


def phase_timing(torch, mods, inputs, engine, batches):
    """Kernel, plain and library times at the main path's shapes, bounds
    from this run's inputs, and the main path's tiles/s."""
    import torch.nn.functional as F

    from caesar_yolo_tpu_torch.ops.zscale import zscale_limits
    (cuda_nms, cuda_attn, cuda_preproc, cuda_stats, cuda_histeq,
     cuda_upsample, cuda_shift, cuda_clahe) = mods
    rows = {}

    boxes_t, valid = inputs["nms"]
    nv = valid.sum(dim=1).double()
    pairs = float((nv * (nv - 1) / 2).sum())    # IoU pairs this data needs
    nbytes = boxes_t.numel() * 4 + valid.numel() * 2
    kernel = lambda: cuda_nms.nms_suppress(boxes_t, valid, 0.5)
    rows["nms"] = r = dict(
        ms=time_ms(torch, kernel),
        plain_ms=time_ms(torch, lambda: cuda_nms.suppress_plain(
            boxes_t.transpose(1, 2), valid, 0.5), iters=5),
        library_ms=None,
        bound=bound_ms(nbytes, 14 * pairs, "float32"))
    split = kernel_split(torch, kernel)
    log(f"timing K1 nms {tuple(boxes_t.shape)}: {r['ms']:.5f} ms (device "
        f"{sum(split.values()):.5f}: {split}), plain {r['plain_ms']:.5f}, "
        f"bound {r['bound'][0]:.6f} ({r['bound'][1]})")

    # K2 at yolo11l's N = 400 (the kernels line) and the mosaic's N = 256;
    # beside the CUDA-event times, each call's device time under the
    # profiler (host launch gaps left out)
    for n in ATTN_NS:
        q, k, v, scale = inputs[f"attn{n}"]
        b, h, _, kd = q.shape
        hd = v.shape[-1]
        flops = 2 * b * h * n * n * (kd + hd) + 5 * b * h * n * n
        nbytes = (q.numel() + k.numel() + 2 * v.numel()) * 2
        kernel = lambda: cuda_attn.attention(q, k, v, scale)
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)
        row = dict(
            ms=time_ms(torch, kernel),
            plain_ms=time_ms(torch, lambda: cuda_attn.attention_plain(
                q, k, v, scale)),
            library_ms=time_ms(torch, sdpa),
            bound=bound_ms(nbytes, flops, "bfloat16"))
        log(f"timing K2 attention {tuple(q.shape)}/{tuple(v.shape)} bf16: "
            f"{row['ms']:.5f} ms (device {device_ms(torch, kernel):.5f}), "
            f"plain {row['plain_ms']:.5f}, SDPA {row['library_ms']:.5f} "
            f"(device {device_ms(torch, sdpa):.5f}), bound "
            f"{row['bound'][0]:.5f} ({row['bound'][1]})")
        if n == ATTN_NS[0]:
            rows["attn"] = row

    # K3 at the main path's tiles (the kernels line) and the eval cutouts
    rng = np.random.default_rng(3)
    for planes in (inputs["preproc"][0],
                   preproc_planes(inputs["preproc"][0].device, rng,
                                  PREPROC_SHAPES[1])):
        vlims = torch.stack(zscale_limits(planes), dim=1)
        kernel = lambda: cuda_preproc.zscale_minmax(planes, vlims)
        r = dict(
            ms=time_ms(torch, kernel),
            plain_ms=time_ms(torch, lambda: cuda_preproc.zscale_minmax_plain(
                planes, vlims)),
            library_ms=None,
            bound=bound_ms(2 * planes.numel() * 4 + 2 * vlims.numel() * 4,
                           12 * planes.numel(), "float32"))
        log(f"timing K3 zscale+minmax {tuple(planes.shape)} "
            f"({cuda_preproc.plan(planes[0].numel())[0]} route): "
            f"{r['ms']:.5f} ms (device {kernel_split(torch, kernel)}), plain "
            f"{r['plain_ms']:.5f}, bound {r['bound'][0]:.6f} "
            f"({r['bound'][1]})")
        rows.setdefault("preproc", r)

    from caesar_yolo_tpu_torch.ops.histeq import equalize_hist
    from caesar_yolo_tpu_torch.ops.stats import clip_stats_plain
    # K5 at the mosaic's tiles (the kernels line) and the serial crop
    sig = MOSAIC_SIGMAS[0]
    x = inputs["stats"]
    crop = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (1, MAIN_SIZE, MAIN_SIZE)).astype(np.float32)).to(x.device)
    for planes in (x, crop):
        kernel = lambda: cuda_stats.clip_stats(planes, *sig)
        r = dict(
            ms=time_ms(torch, kernel),
            plain_ms=time_ms(torch, lambda: clip_stats_plain(
                planes, None, *sig), iters=5),
            library_ms=None,
            bound=bound_ms(planes.numel() * 4, 0, "float32"))
        log(f"timing K5 sigma-clip stats {tuple(planes.shape)} "
            f"({cuda_stats.plan(planes[0].numel())[0]} route): "
            f"{r['ms']:.5f} ms (device {device_ms(torch, kernel):.5f}), "
            f"plain {r['plain_ms']:.5f}, bound {r['bound'][0]:.6f} "
            f"({r['bound'][1]})")
        rows.setdefault("stats", r)
    # K6 at the mosaic's tiles (the kernels line), the serial crop (cluster
    # route) and planes past the cluster route's limit (stream route)
    rng, dev = np.random.default_rng(2), inputs["histeq"].device
    for planes in (inputs["histeq"],
                   histeq_planes(dev, rng, (1, MAIN_SIZE, MAIN_SIZE)),
                   histeq_planes(dev, rng, HISTEQ_SHAPES[-1])):
        kernel = lambda: cuda_histeq.equalize_hist_batch(planes)
        r = dict(
            ms=time_ms(torch, kernel),
            plain_ms=time_ms(torch, lambda: equalize_hist(planes), iters=5),
            library_ms=None,
            bound=bound_ms(2 * planes.numel() * 4, 0, "float32"))
        log(f"timing K6 hist-eq {tuple(planes.shape)} "
            f"({cuda_histeq.plan(planes[0].numel())[0]} route): "
            f"{r['ms']:.5f} ms (device {kernel_split(torch, kernel)}), plain "
            f"{r['plain_ms']:.5f}, bound {r['bound'][0]:.6f} "
            f"({r['bound'][1]})")
        rows.setdefault("histeq", r)

    q, k, v, g, scale = inputs["attn_bwd"]
    b, h, n, kd = q.shape
    hd = v.shape[-1]
    flops = 2 * b * h * n * n * (3 * kd + 2 * hd)
    nbytes = (4 * q.numel() + 3 * v.numel()) * 2   # q,k,v,dO in; dq,dk,dv out
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    sdpa = F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
    kernel = lambda: cuda_attn.attention_backward(q, k, v, g, scale)
    sdpa_bwd = lambda: torch.autograd.grad(sdpa, (ql, kl, vl), g,
                                           retain_graph=True)
    rows["attn_bwd"] = dict(
        ms=time_ms(torch, kernel),
        plain_ms=time_ms(torch, lambda: cuda_attn.attention_backward_plain(
            q, k, v, g, scale), iters=5),
        library_ms=time_ms(torch, sdpa_bwd),
        bound=bound_ms(nbytes, flops, "bfloat16"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    grads = kernel()
    torch.cuda.synchronize()
    extra = (torch.cuda.max_memory_allocated() - base
             - sum(t.numel() * t.element_size() for t in grads))
    r = rows["attn_bwd"]
    split = kernel_split(torch, kernel)
    log(f"timing K2-bwd attention {tuple(q.shape)}/{tuple(v.shape)} bf16: "
        f"{r['ms']:.5f} ms (device {sum(split.values()):.5f}: {split}), plain "
        f"{r['plain_ms']:.5f}, SDPA's backward {r['library_ms']:.5f} (device "
        f"{device_ms(torch, sdpa_bwd):.5f}), bound {r['bound'][0]:.5f} "
        f"({r['bound'][1]}); peak device memory of one call beyond its "
        f"inputs and outputs {extra / 2**20:.3f} MiB")

    x, gy = inputs["upsample"]
    xl = x.detach().clone().requires_grad_()
    interp = F.interpolate(xl, scale_factor=2, mode="nearest")
    rows["upsample"] = dict(
        ms=time_ms(torch, lambda: cuda_upsample.upsample2x_forward(x)),
        plain_ms=time_ms(torch, lambda: cuda_upsample.upsample2x_plain(x)),
        library_ms=time_ms(torch, lambda: F.interpolate(
            x, scale_factor=2, mode="nearest")),
        bound=bound_ms(5 * x.numel() * x.element_size(), 0, "bfloat16"))
    # K4's backward at the path's input, the concat's channel slice (the
    # kernels line), beside it on a contiguous gradient and the parent's
    # channels_last copy of the slice
    kernel = lambda: cuda_upsample.upsample2x_backward(gy)
    rows["upsample_bwd"] = r = dict(
        ms=time_ms(torch, kernel),
        plain_ms=time_ms(
            torch, lambda: cuda_upsample.upsample2x_backward_plain(gy)),
        library_ms=time_ms(torch, lambda: torch.autograd.grad(
            interp, xl, gy, retain_graph=True)),
        bound=bound_ms(5 * x.numel() * x.element_size(), 3 * x.numel(),
                       "float32"))
    contig = gy.contiguous(memory_format=torch.channels_last)
    on_contig = lambda: cuda_upsample.upsample2x_backward(contig)
    copy = lambda: gy.contiguous(memory_format=torch.channels_last)
    log(f"timing K4 upsample backward {tuple(gy.shape)} bf16, the concat's "
        f"slice (strides {gy.stride()}): {r['ms']:.5f} ms (device "
        f"{kernel_split(torch, kernel)}); on a contiguous gradient "
        f"{time_ms(torch, on_contig):.5f}"
        f"; the channels_last copy of the slice (the parent's wrapper) "
        f"{time_ms(torch, copy):.5f} (device {device_ms(torch, copy):.5f}); "
        f"plain {r['plain_ms']:.5f}, F.interpolate's backward "
        f"{r['library_ms']:.5f}, bound {r['bound'][0]:.5f} ({r['bound'][1]})")

    # K8 at the training canvas on the augmentation's shears: the row route
    # (the x-shear), the column route on the transposed view (the y-shear)
    # and, for the y-shear, the transposed copy and row launch it replaces.
    # The kernels line takes the mean of the two routes, which the path
    # launches once each an augmented batch.
    way_rows = {}
    for way in ("row", "column"):
        imgs, shifts = inputs[f"shift_{way}"]
        kernel = lambda: cuda_shift.fractional_row_shift_batch(
            imgs, shifts, SHIFT_PAD, 114.0 / 255.0)
        way_rows[way] = r = dict(
            ms=time_ms(torch, kernel),
            plain_ms=time_ms(torch, lambda: cuda_shift.row_shift_plain(
                imgs, shifts, SHIFT_PAD, 114.0 / 255.0), iters=5),
            library_ms=None,
            bound=bound_ms(2 * imgs.numel() * 4 + shifts.numel() * 4,
                           4 * imgs.numel(), "float32"))
        log(f"timing K8 row shift {tuple(imgs.shape)} {way} route: "
            f"{r['ms']:.5f} ms (device {kernel_split(torch, kernel)}), plain "
            f"{r['plain_ms']:.5f}, bound {r['bound'][0]:.5f} "
            f"({r['bound'][1]})")
    copy = lambda: cuda_shift.fractional_row_shift_batch(
        imgs.contiguous(), shifts, SHIFT_PAD, 114.0 / 255.0)
    log(f"timing K8 y-shear as a transposed copy and a row launch: "
        f"{time_ms(torch, copy):.5f} ms (device {kernel_split(torch, copy)})")
    rows["shift"] = dict(
        ms=(way_rows["row"]["ms"] + way_rows["column"]["ms"]) / 2,
        plain_ms=(way_rows["row"]["plain_ms"]
                  + way_rows["column"]["plain_ms"]) / 2,
        library_ms=None, bound=way_rows["row"]["bound"])

    # K7's whole call at the eval path's planes (the kernels line) and at
    # the tile size, beside the stream route's histogram and blend launches
    # (the two kernels of the design before the cluster route).  Bytes: read
    # each plane once and write it once; operations: 3 flops a pixel to bin
    # it, 9 to blend it
    from caesar_yolo_tpu_torch.ops import clahe
    x = inputs["clahe"]
    for shape in (tuple(x.shape), (MAIN_BATCH, MAIN_SIZE, MAIN_SIZE)):
        if shape != tuple(x.shape):
            x = clahe_planes(dev, *shape, seed=2, edge_cases=False)
        kernel = lambda: cuda_clahe.equalize_adapthist_batch(x, 0.03)
        r = dict(
            ms=time_ms(torch, kernel),
            plain_ms=time_ms(torch, lambda: clahe.equalize_adapthist_plain(
                x, 0.03), iters=5),
            library_ms=None,
            bound=bound_ms(2 * x.numel() * 4, 12 * x.numel(), "float32"))
        vmin, span = clahe.value_range(x)
        th, tw = clahe.tile_size(*shape[1:])
        cdf = clahe.cdf_tables(cuda_clahe.tile_histograms(x, vmin, span),
                               th * tw, 0.03)
        hist_ms = time_ms(torch, lambda: cuda_clahe.tile_histograms(
            x, vmin, span))
        blend_ms = time_ms(torch, lambda: cuda_clahe.blend(x, vmin, span,
                                                           cdf))
        stream = lambda: cuda_clahe.launch(x, 0.03, clahe.GRID, "stream", 0,
                                           0, 0)
        log(f"timing K7 CLAHE {shape} ({cuda_clahe.plan(*shape[1:])[0]} "
            f"route, {cuda_clahe.plan(*shape[1:])[1]} blocks a cluster): "
            f"whole call {r['ms']:.5f} ms (device "
            f"{kernel_split(torch, kernel)}), plain {r['plain_ms']:.5f}, "
            f"bound {r['bound'][0]:.6f} ({r['bound'][1]}); stream route "
            f"{time_ms(torch, stream):.5f} ms (device "
            f"{kernel_split(torch, stream)}); its histogram launch "
            f"{hist_ms:.5f} ms and blend launch {blend_ms:.5f} ms")
        rows.setdefault("clahe", r)

    staged = [engine.put_tiles(bt) for bt in batches]
    device_tps = staged_tps(torch, engine, staged)
    t0 = time.perf_counter()
    for bt in batches:
        engine.process(bt)
    host_tps = len(batches) * MAIN_BATCH / (time.perf_counter() - t0)
    log(on_card(f"main path throughput: {device_tps:.1f} tiles/s on staged "
                f"tiles, {host_tps:.1f} tiles/s host numpy in -> numpy out "
                f"(yolo11l@{MAIN_SIZE} bf16, batch {MAIN_BATCH})"))
    return rows


def mosaic_plane(torch, tmp, shape):
    """A whole-mosaic plane [1, H, W] f32 on the card: the mosaic phase's
    FITS as the reader gives it at its size, else a seeded plane made on
    the card the same way (noise, bright sources, a zero border 16 px wide
    and a zero block)."""
    from caesar_yolo_tpu_torch.utils.fits import read_fits
    if shape == (1, MOSAIC_SIZE, MOSAIC_SIZE):
        data = read_fits(os.path.join(tmp, "mosaic.fits"))[0]
        return torch.from_numpy(np.ascontiguousarray(data, np.float32)
                                ).cuda()[None]
    _, h, w = shape
    g = torch.Generator(device="cuda").manual_seed(h)
    x = torch.randn(shape, generator=g, device="cuda") * 0.1
    bright = torch.rand(shape, generator=g, device="cuda") < 1e-4
    x += bright * 50.0 * torch.rand(shape, generator=g, device="cuda")
    x[:, :16] = 0.0
    x[:, -16:] = 0.0
    x[:, :, :16] = 0.0
    x[:, :, -16:] = 0.0
    x[:, h // 3:h // 3 + h // 10, w // 5:w // 5 + w // 10] = 0.0
    return x


def phase_whole_plane(torch, tmp):
    """K3, K5 (the mosaic chain's three sigma pairs) and K6 on one
    whole-mosaic plane of each of WHOLE_PLANES (the phase's mosaic, 16384
    px, and 2^30 + 32768 values), each on its stream route (counted),
    against its plain version under its rule (K3 and K6 bit-equal, K5 by
    cuda_stats.stats_mismatch), then timed beside its plain version and
    bound; each plane is freed before the next.  Returns the kernels-line
    rows at the mosaic's size and the rows of every size."""
    from caesar_yolo_tpu_torch.ops import cuda_histeq, cuda_preproc, cuda_stats
    from caesar_yolo_tpu_torch.ops.histeq import equalize_hist
    from caesar_yolo_tpu_torch.ops.stats import clip_stats_plain
    from caesar_yolo_tpu_torch.ops.zscale import zscale_limits

    rows, line = [], {}
    for shape in WHOLE_PLANES:
        x = mosaic_plane(torch, tmp, shape)
        n = x.numel()
        big = n > 2 ** 26
        huge = n > 2 ** 30
        vlims = torch.stack(zscale_limits(x), dim=1)
        kernels = {
            "preproc": (lambda: cuda_preproc.zscale_minmax(x, vlims),
                        lambda: cuda_preproc.zscale_minmax_plain(x, vlims),
                        cuda_preproc.zscale_minmax,
                        bound_ms(2 * n * 4 + 16, 12 * n, "float32")),
            "stats": (lambda: cuda_stats.clip_stats(x, *MOSAIC_SIGMAS[0]),
                      lambda: clip_stats_plain(x, None, *MOSAIC_SIGMAS[0]),
                      cuda_stats.clip_stats, bound_ms(n * 4, 0, "float32")),
            "histeq": (lambda: cuda_histeq.equalize_hist_batch(x),
                       lambda: equalize_hist(x),
                       cuda_histeq.equalize_hist_batch,
                       bound_ms(2 * n * 4, 0, "float32"))}
        for key, (kernel, plain, wrapper, bound) in kernels.items():
            err = 0.0
            if key == "stats":
                for sig in MOSAIC_SIGMAS:
                    err = max(err, parity_stats(torch, x, sig, "stream", 16))
            else:
                before = wrapper.stream_launches
                got = kernel()
                torch.cuda.synchronize()
                ran = wrapper.stream_launches == before + 1
                ref = plain()
                if key == "preproc":
                    same = (torch.equal(got[0], ref[0])
                            and torch.equal(got[1], ref[1]))
                    err = (got[0] - ref[0]).abs().max().item()
                else:
                    same = (torch.equal(got.isnan(), ref.isnan())
                            and torch.equal(got.nan_to_num(),
                                            ref.nan_to_num()))
                    err = (got.nan_to_num() - ref.nan_to_num()
                           ).abs().max().item()
                log(f"parity {key} {shape} (stream route, counted {ran}): "
                    f"max abs err {err:.3g} (tolerance 0), bit-equal {same}")
                require(ran and same, f"{key} kernel differs on the whole "
                        f"plane {shape}")
                del got, ref
            row = dict(shape=list(shape), kernel=key,
                       ms=time_ms(torch, kernel,
                                  iters=3 if huge else 5 if big else 20,
                                  warmup=1 if huge else 3),
                       plain_ms=time_ms(torch, plain,
                                        iters=1 if huge else 2 if big else 5,
                                        warmup=0 if huge else 1),
                       library_ms=None, bound=bound, max_abs_err=err)
            log(f"timing {key} whole plane {shape} (stream route): "
                f"{row['ms']:.5f} ms, plain {row['plain_ms']:.5f}, bound "
                f"{bound[0]:.6f} ({bound[1]})")
            rows.append(row)
            if not big:
                line[f"{key}_plane"] = row
        del x, vlims, kernels
        torch.cuda.empty_cache()
    return line, rows


KERNELS = {
    "nms": ("nms_suppress", "caesar_yolo_tpu_torch/csrc/nms.cu",
            "caesar_yolo_tpu/detect/pallas_nms.py:85"),
    "attn": ("attention", "caesar_yolo_tpu_torch/csrc/attn.cu",
             "caesar_yolo_tpu/models/pallas_attn.py:132"),
    "preproc": ("zscale_minmax", "caesar_yolo_tpu_torch/csrc/preproc.cu",
                "caesar_yolo_tpu/ops/pallas_preproc.py:72"),
    "stats": ("clip_stats", "caesar_yolo_tpu_torch/csrc/stats.cu",
              "caesar_yolo_tpu/ops/pallas_stats.py:146"),
    "histeq": ("equalize_hist_batch", "caesar_yolo_tpu_torch/csrc/histeq.cu",
               "caesar_yolo_tpu/ops/pallas_histeq.py:133"),
    "attn_bwd": ("attention_backward", "caesar_yolo_tpu_torch/csrc/attn_bwd.cu",
                 "caesar_yolo_tpu/models/pallas_attn.py:106"),
    "upsample": ("upsample2x_forward", "caesar_yolo_tpu_torch/csrc/upsample.cu",
                 "caesar_yolo_tpu/ops/pallas_upsample.py:56"),
    "upsample_bwd": ("upsample2x_backward",
                     "caesar_yolo_tpu_torch/csrc/upsample.cu",
                     "caesar_yolo_tpu/ops/pallas_upsample.py:56"),
    "shift": ("fractional_row_shift_batch",
              "caesar_yolo_tpu_torch/csrc/shift.cu",
              "caesar_yolo_tpu/ops/pallas_shift.py:54"),
    "clahe": ("equalize_adapthist_batch", "caesar_yolo_tpu_torch/csrc/clahe.cu",
              "caesar_yolo_tpu/ops/pallas_clahe.py:137"),
    "qconv": ("qconv (int8 conv; no TPU kernel: XLA's s8 conv)",
              "caesar_yolo_tpu_torch/csrc/qconv.cu",
              "caesar_yolo_tpu/models/layers.py:139"),
    "epilogue": ("conv_epilogue (bf16 conv epilogue; no TPU kernel: XLA's "
                 "fused conv epilogue)",
                 "caesar_yolo_tpu_torch/csrc/epilogue.cu",
                 "caesar_yolo_tpu/models/layers.py:169"),
    # the stream routes on one whole-mosaic plane (global context)
    "preproc_plane": (f"zscale_minmax stream route [1,{MOSAIC_SIZE},"
                      f"{MOSAIC_SIZE}]",
                      "caesar_yolo_tpu_torch/csrc/preproc.cu",
                      "caesar_yolo_tpu/ops/pallas_preproc.py:72"),
    "stats_plane": (f"clip_stats stream route [1,{MOSAIC_SIZE},"
                    f"{MOSAIC_SIZE}]", "caesar_yolo_tpu_torch/csrc/stats.cu",
                    "caesar_yolo_tpu/ops/pallas_stats.py:146"),
    "histeq_plane": (f"equalize_hist_batch stream route [1,{MOSAIC_SIZE},"
                     f"{MOSAIC_SIZE}]",
                     "caesar_yolo_tpu_torch/csrc/histeq.cu",
                     "caesar_yolo_tpu/ops/pallas_histeq.py:133"),
}
# where each whole-plane row's launches are counted: the global-context
# mosaic runs (K3 with the README chain)
PLANE_RUNS = {"preproc_plane": ("global-readme", "preproc"),
              "stats_plane": ("global", "stats"),
              "histeq_plane": ("global", "histeq")}


def main() -> int:
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        log("FAIL: PyTorch is not installed")
        return 1
    if not torch.cuda.is_available():
        log("FAIL: no CUDA device")
        return 1
    if not os.path.isdir(os.path.join(REPO, "caesar_yolo_tpu_torch")):
        log("FAIL: run chip_smoke.py from a checkout of the repository")
        return 1
    sys.path.insert(0, REPO)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        card = smi.stdout.strip().splitlines()[0] if smi.stdout else ""
        require(smi.returncode == 0 and card, "nvidia-smi failed")
        global CARD
        CARD = card
        log(card)
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{torch.cuda.get_device_name(0)}")

        from caesar_yolo_tpu_torch import cuda_build
        from caesar_yolo_tpu_torch.detect import cuda_nms
        from caesar_yolo_tpu_torch.models import cuda_attn, cuda_qconv
        from caesar_yolo_tpu_torch.ops import (cuda_clahe, cuda_histeq,
                                               cuda_preproc, cuda_shift,
                                               cuda_stats, cuda_upsample)

        t0 = time.perf_counter()
        cuda_build.build()
        log(f"build: {sorted(cuda_build.SOURCES)} in "
            f"{time.perf_counter() - t0:.1f} s")
        mods = (cuda_nms, cuda_attn, cuda_preproc, cuda_stats, cuda_histeq,
                cuda_upsample, cuda_shift, cuda_clahe)
        counters = {"nms": cuda_nms.nms_suppress,
                    "attn": cuda_attn.attention,
                    "preproc": cuda_preproc.zscale_minmax,
                    "stats": cuda_stats.clip_stats,
                    "histeq": cuda_histeq.equalize_hist_batch,
                    "attn_bwd": cuda_attn.attention_backward,
                    "upsample": cuda_upsample.upsample2x_forward,
                    "upsample_bwd": cuda_upsample.upsample2x_backward,
                    "shift": cuda_shift.fractional_row_shift_batch,
                    "clahe": cuda_clahe.equalize_adapthist_batch,
                    "qconv": cuda_qconv.qconv}

        errs, inputs = phase_parity(torch)
        phase_yolo12(torch)
        phase_golden(torch)
        phase_golden_train(torch)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            phase_golden_eval(torch, counters, tmp)
            phase_golden_mosaic(torch, tmp)
            engine, model, batches, launches = phase_main(torch, counters)
            epilogue_inputs, epilogue_err = phase_epilogue(
                torch, engine, model, batches)
            phase_export(torch, counters, engine, batches, tmp)
            mosaic_launches, _ = phase_mosaic(torch, counters, tmp)
            phase_multiproc(torch, tmp)
            phase_profile(torch, tmp)
            phase_resume(torch, tmp)
            phase_pt(torch, counters, tmp)
            phase_weights(torch, tmp)
            phase_image(torch, counters, tmp)
            eval_launches = phase_eval(torch, counters, tmp, card)
            train_launches = phase_train(torch, counters, tmp, card)
            phase_upsample_ab(torch, engine, model, batches, tmp)
            phase_shear_ab(torch, card)
            plane_rows, planes = phase_whole_plane(torch, tmp)
            q5_model, q5_bf16 = phase_synth5(torch)
            phase_golden_bf16(torch)
            qconv_row, qconv_launches = phase_int8(torch, counters, tmp,
                                                   q5_model, q5_bf16)
        rows = phase_timing(torch, mods, inputs, engine, batches)
        rows.update(plane_rows)
        errs.update({k: r["max_abs_err"] for k, r in plane_rows.items()})
        rows["qconv"] = qconv_row
        errs["qconv"] = qconv_row["max_abs_err"]
        rows["epilogue"] = epilogue_timing(torch, epilogue_inputs,
                                           epilogue_err)
        errs["epilogue"] = epilogue_err
    except Exception:  # report every failure before exiting non-zero
        traceback.print_exc()
        log("FAIL")
        return 1

    # each kernel's launches on the path that runs it: K3 and K10 on the
    # README main path, K1, K2, K5 and K6 on the mosaic CLI path's tiled
    # run, K4 and the training kernels on the training CLI's first run, K7
    # on the eval phase's CLAHE run, K9 on cli.run --int8
    launches = {k: (launches[k] if k in ("preproc", "epilogue")
                    else qconv_launches if k == "qconv"
                    else train_launches[k] if k in TRAIN_ONLY + ("upsample",)
                    else eval_launches["evaluate_dataset+CLAHE"][k]
                    if k in CLAHE
                    else mosaic_launches[PLANE_RUNS[k][0]][PLANE_RUNS[k][1]]
                    if k in PLANE_RUNS
                    else mosaic_launches["auto"][k]) for k in KERNELS}
    kernels = []
    for key, (name, source, replaces) in KERNELS.items():
        r = rows[key]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": errs[key], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"]})
    log(json.dumps({"whole_plane": [
        {"kernel": r["kernel"], "shape": r["shape"], "route": "stream",
         "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
         "bound_by": r["bound"][1], "max_abs_err": r["max_abs_err"]}
        for r in planes]}))
    log(f"chip_smoke.py took {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
