"""The batched tile-detection engine on one GPU.

Counterpart of caesar_yolo_tpu/parallel/engine.py (`make_tile_step`,
`TileEngine`): per tile batch, gray -> 3 channels, the preprocessing
pipeline, the degenerate-channel guard, letterbox, the YOLO forward pass
(bf16 on CUDA), DFL decode, fixed-shape NMS and unletterbox, with
`tile_ok` masking the detections of tiles that cannot be predicted on.

Device-resident tiling (the reference's engine.py:204-305): a mosaic, or
a full-width band of one, is shipped to the device once (`put_mosaic`),
optionally preprocessed there as one plane (`preprocess_mosaic`, the
global statistics context), and batches of windows are cut from it on
the device by one gather (`process_mosaic_async`).  On several GPUs each
process runs its own engine (parallel/mesh.py, parallel/sfinder.py).
The serving export (deploy.py) traces `make_tile_step`'s step.

On CUDA the engine replays the step as a CUDA graph instead of issuing
its ~1000 launches from Python each batch.  The first batch of an input
(shape, dtype, raw or preprocessed) runs eagerly, which is the warm-up
capture needs (cuDNN's choices, the kernels' attributes, the cached
anchors); the second is captured into a graph that reads a static input
buffer, then replayed; every later one is copied into that buffer and
replayed, and its outputs are cloned out of the graph's, so a batch's
outputs outlive the next replay.  A shape seen once is never captured; a
capture that raises (a stage that waits on the host) is counted, warned
about once, and that input runs eagerly from then on.  `update_params`
drops every graph.  The live graphs of every engine on a device share
one capture stream and one memory pool (`_CAPTURE`), so an engine a field
reserves no more memory than the first, and the pool is freed once no
engine holds a graph.  The wrappers' launch counters
(cuda_build.COUNTERS) advance on each replay by what they counted while
the step was captured.  On the CPU nothing is captured.

`recorder` (utils/trace.py) is the span recorder of the run driving the
engine, set by that run (the SFinder) for its duration: staging is the
span `engine.stage` (child `engine.pin`), each dispatched batch the span
`engine.dispatch` (child `engine.origins`) with its device events, and
the counters `engine.eager_batches`, `engine.graph_captures`,
`engine.graph_replays` (the captured batch among them) and
`engine.graph_fallbacks` say how each batch ran.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from caesar_yolo_tpu_torch import cuda_build, logger
from caesar_yolo_tpu_torch.detect.nms import DEFAULT_PRE_NMS
from caesar_yolo_tpu_torch.detect.predictor import (detect_images,
                                                   prepare_model)
from caesar_yolo_tpu_torch.models.yolo import YOLO
from caesar_yolo_tpu_torch.ops.transforms import prepare_tiles
from caesar_yolo_tpu_torch.utils.device import resolve_device
from caesar_yolo_tpu_torch.utils.trace import NULL

EAGER_BATCHES = "engine.eager_batches"
GRAPH_CAPTURES = "engine.graph_captures"
GRAPH_REPLAYS = "engine.graph_replays"
GRAPH_FALLBACKS = "engine.graph_fallbacks"
_SEEN, _EAGER = "seen", "eager"     # an input's state before or without a graph
# Every engine's graphs on a device are captured on one stream into the
# memory pool of the device's live graphs, which are held here weakly.
# Blocks freed in a pool serve only captures on the stream they were made
# on, and a dead graph's pool is freed only by torch.cuda.empty_cache or,
# outside a capture, under memory pressure, so a stream and a pool for
# each engine would pile up a batch's activations a field (3.5 GB for
# yolo11l at batch 32) until a capture no longer fits.  So a capture that
# finds no live graph on its device first empties the cache, which frees
# the pool of the graphs that died.  Graphs sharing a pool may overwrite
# each other's memory when replayed, which is safe here: every replay runs
# on the caller's stream and its outputs are cloned there before any other
# replay starts.
_CAPTURE: dict[int, list] = {}   # device index -> [stream, WeakSet of _Graph]


def make_tile_step(model: YOLO, *, preprocessor=None, img_size: int = 640,
                   score_thr: float = 0.25, iou_thr: float = 0.5,
                   max_det: int = 300, pre_nms: int = DEFAULT_PRE_NMS):
    """step(tiles[B, H, W, C]) -> (boxes in tile coords, scores, cls,
    valid, tile_ok, n_dropped) for a model already on its device and in
    its compute dtype (predictor.prepare_model)."""
    nchan = model.in_channels

    def step(tiles):
        imgs, tile_ok = prepare_tiles(tiles, preprocessor, nchan)
        bsel, ssel, csel, vsel, ndrop = detect_images(
            model, imgs, img_size=img_size, score_thr=score_thr,
            iou_thr=iou_thr, max_det=max_det, pre_nms=pre_nms)
        return bsel, ssel, csel, vsel & tile_ok[:, None], tile_ok, ndrop

    return step


def _counted_since(before: list[int]) -> list[int]:
    """How far each launch counter moved since cuda_build.counter_values()
    gave `before`."""
    return [n - b for n, b in zip(cuda_build.counter_values(), before)]


class _Graph:
    """The step captured for one input: the static input it reads, the
    static outputs it writes, and how far each launch counter
    (cuda_build.COUNTERS) advanced while it was captured."""

    def __init__(self, step, tiles: torch.Tensor):
        dev = tiles.device
        shared = _CAPTURE.get(dev.index)
        if shared is None:
            shared = _CAPTURE[dev.index] = [torch.cuda.Stream(dev),
                                            weakref.WeakSet()]
        stream, live = shared
        pool = next((g.graph.pool() for g in live), None)
        if pool is None:
            torch.cuda.empty_cache()
        self.input = torch.empty_like(tiles)
        self.input.copy_(tiles)
        self.graph = torch.cuda.CUDAGraph()
        before = cuda_build.counter_values()
        stream.wait_stream(torch.cuda.current_stream(dev))
        try:
            with torch.cuda.stream(stream):
                # thread_local: the band and stream paths' staging threads
                # may call the CUDA API meanwhile
                self.graph.capture_begin(
                    pool=pool, capture_error_mode="thread_local")
                try:
                    self.outputs = step(self.input)
                finally:
                    self.graph.capture_end()
        except BaseException:
            # nothing ran: take back what the capture counted; and capture
            # on a fresh stream next, in case this one's allocations are
            # still routed to the pool
            cuda_build.add_to_counters(
                [-n for n in _counted_since(before)])
            shared[0] = torch.cuda.Stream(dev)
            raise
        finally:
            torch.cuda.current_stream(dev).wait_stream(stream)
        live.add(self)
        self.advance = _counted_since(before)

    def replay(self, tiles: torch.Tensor | None):
        """The step's outputs on `tiles`, in tensors of their own.  None:
        on the batch it was captured on, whose launches were counted
        then."""
        if tiles is not None:
            self.input.copy_(tiles)
        self.graph.replay()
        if tiles is not None:
            cuda_build.add_to_counters(self.advance)
        return tuple(t.clone() for t in self.outputs)


class TileEngine:
    """Batch detector for fixed-size tiles on one device.

    process(tiles[B, H, W, C]) -> host numpy
      (boxes[B, MAXDET, 4] xyxy in TILE coords, scores[B, MAXDET],
       class_ids[B, MAXDET], valid[B, MAXDET], tile_ok[B], n_dropped[B]).
    n_dropped counts above-threshold candidates truncated by the pre_nms
    window (callers must log nonzero counts).

    `device` defaults to CUDA (and raises without it); pass "cpu" to run
    on the CPU.  relay_dtype="bfloat16" ships tiles host->device in bf16
    (half the bytes, 8-bit mantissa) and upcasts them on the device.
    The engine runs prepare_model's inference model of `model` in
    `compute_dtype` (None: the model's own, or COMPUTE_DTYPE).
    """

    def __init__(self, model: YOLO, *,
                 compute_dtype: torch.dtype | None = None, device=None,
                 preprocessor=None, img_size: int = 640,
                 score_thr: float = 0.7, iou_thr: float = 0.5,
                 max_det: int = 300, pre_nms: int = DEFAULT_PRE_NMS,
                 relay_dtype: str = "float32"):
        self.device = resolve_device(device)
        self.recorder = NULL
        self._warned = False
        self.relay_dtype = (torch.bfloat16
                            if str(relay_dtype) in ("bfloat16", "bf16")
                            else torch.float32)
        self.compute_dtype = compute_dtype
        self.preprocessor = preprocessor
        self._step_kwargs = dict(
            img_size=img_size, score_thr=score_thr, iou_thr=iou_thr,
            max_det=max_det, pre_nms=pre_nms)
        self.update_params(model)

    def update_params(self, model: YOLO) -> None:
        """Run prepare_model's inference model of `model` (e.g. a
        trainer's EMA model, for validation during training) at the
        engine's compute dtype and on its device: `model` itself where it
        is one already, else a copy, BatchNorm folded and cast, so the
        caller's modules are never changed."""
        self.model = prepare_model(model, dtype=self.compute_dtype,
                                   device=self.device)
        self.compute_dtype = self.model.compute_dtype
        # the step of raw tiles, and of tiles cut from a mosaic that
        # preprocess_mosaic has already preprocessed (gray -> 3 channels and
        # the degenerate-channel guard only)
        self._step = make_tile_step(self.model, preprocessor=self.preprocessor,
                                    **self._step_kwargs)
        self._step_preprocessed = make_tile_step(
            self.model, preprocessor=None, **self._step_kwargs)
        # the graphs read the old weights' addresses
        self._graphs: dict[tuple, _Graph | str] = {}

    def _run(self, tiles: torch.Tensor, preprocessed: bool):
        """The step on a device batch: eagerly, or from its input's CUDA
        graph (see the module's docstring)."""
        step = self._step_preprocessed if preprocessed else self._step
        if tiles.device.type != "cuda" or not tiles.is_contiguous():
            return self._eager(step, tiles)
        key = (tuple(tiles.shape), tiles.dtype, preprocessed)
        state = self._graphs.get(key)
        if state is None:
            self._graphs[key] = _SEEN
            return self._eager(step, tiles)
        if state is _EAGER:
            return self._eager(step, tiles)
        if state is _SEEN:
            try:
                state = _Graph(step, tiles)
            except Exception as exc:
                self._graphs[key] = _EAGER
                self.recorder.add(GRAPH_FALLBACKS, 1)
                if not self._warned:
                    self._warned = True
                    logger.warning(
                        "Tile step of %s %s tiles cannot be captured as a "
                        "CUDA graph (%s: %s); running it eagerly",
                        tuple(tiles.shape), tiles.dtype,
                        type(exc).__name__, exc)
                return self._eager(step, tiles)
            self._graphs[key] = state
            self.recorder.add(GRAPH_CAPTURES, 1)
            tiles = None    # the capture holds this batch
        self.recorder.add(GRAPH_REPLAYS, 1)
        return state.replay(tiles)

    def _eager(self, step, tiles):
        self.recorder.add(EAGER_BATCHES, 1)
        return step(tiles)

    def put_tiles(self, tiles: np.ndarray) -> torch.Tensor:
        """Stage a host tile batch on the device in the relay dtype
        (pinned and asynchronous on CUDA)."""
        with self.recorder.span("engine.stage"):
            t = torch.from_numpy(np.ascontiguousarray(tiles, np.float32))
            t = t.to(self.relay_dtype)
            if self.device.type == "cuda":
                with self.recorder.span("engine.pin"):
                    t = t.pin_memory()
            return t.to(self.device, non_blocking=True)

    @torch.inference_mode()
    def process_async(self, tiles, batch: int | None = None):
        """Enqueue one batch without waiting for the device; returns
        device tensors.  Takes a host array or a staged tensor.  `batch`
        is the run's index of the batch (its spans and device events)."""
        with self.recorder.span("engine.dispatch", batch), \
                self.recorder.on_device(batch, self.device):
            if isinstance(tiles, np.ndarray):
                tiles = self.put_tiles(tiles)
            return self._run(tiles, preprocessed=False)

    def process(self, tiles):
        return tuple(self.to_host_async(self.process_async(tiles))())

    def to_host_async(self, outs):
        """Start copying a dispatched batch's outputs to the host without
        waiting (into pinned buffers on CUDA); returns a function that
        waits for this batch's copies alone and gives them as numpy
        arrays.  `Tensor.cpu()` would also wait for every batch queued on
        the stream after this one, and the device would idle while the
        host unpacks."""
        if self.device.type != "cuda":
            return lambda: [t.numpy() for t in outs]
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in outs]
        for h, t in zip(host, outs):
            h.copy_(t, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record()

        def wait():
            copied.synchronize()
            return [h.numpy() for h in host]

        return wait

    # -- device-resident mosaic tiling ---------------------------------------

    def put_mosaic(self, mosaic: np.ndarray) -> torch.Tensor:
        """Ship a mosaic (or a full-width band of one) [H, W] to the device
        once, in the relay dtype, pinned and asynchronous on CUDA: windows
        are then cut on the device, so no overlap pixel crosses the link
        twice."""
        return self.put_tiles(mosaic)

    @torch.inference_mode()
    def preprocess_mosaic(self, mosaic_dev: torch.Tensor):
        """The pipeline run once over the whole device-resident mosaic (the
        global statistics context) -> (f32 [H, W], whether it is valid).
        As the reference (engine.py:220-252) it runs on the mosaic as one
        gray plane [1, H, W, 1] and keeps channel 0 of the result."""
        if self.preprocessor is None:
            return mosaic_dev, True
        out, ok = self.preprocessor.apply_batch(
            mosaic_dev.float()[None, :, :, None])
        return out[0, :, :, 0].contiguous(), bool(ok[0])

    @torch.inference_mode()
    def process_mosaic_async(self, mosaic_dev: torch.Tensor,
                             origins: np.ndarray, tile_shape: tuple[int, int],
                             preprocessed: bool = False,
                             batch: int | None = None):
        """Detect a batch of windows cut from a device-resident mosaic
        [H, W]: origins [B, 2] (row, column) of each window's corner, all of
        shape tile_shape = (h, w) (padding slots take (0, 0)).  Same outputs
        as process_async.  preprocessed=True: the mosaic went through
        preprocess_mosaic, so only gray -> 3 channels and the
        degenerate-channel guard run on the windows.  `batch` as in
        process_async."""
        h, w = tile_shape
        dev = mosaic_dev.device
        with self.recorder.span("engine.dispatch", batch), \
                self.recorder.on_device(batch, dev):
            origins = np.asarray(origins, np.int64).reshape(-1, 2)
            H, W = mosaic_dev.shape
            if (origins < 0).any() or (origins[:, 0] + h > H).any() or (
                    origins[:, 1] + w > W).any():
                raise ValueError(f"windows {tile_shape} at "
                                 f"{origins.tolist()} leave the mosaic "
                                 f"{(H, W)}")
            with self.recorder.span("engine.origins"):
                o = torch.from_numpy(origins)
                if dev.type == "cuda":
                    # pinned, so that the copy waits for nothing
                    o = o.pin_memory().to(dev, non_blocking=True)
            rows = o[:, :1] + torch.arange(h, device=dev)          # [B, h]
            cols = o[:, 1:] + torch.arange(w, device=dev)          # [B, w]
            tiles = mosaic_dev[rows[:, :, None], cols[:, None, :]]  # 1 gather
            return self._run(tiles[..., None], preprocessed)
