"""Mosaic-scale source finding: tiling, batched inference, edge handling,
stitching, catalog output, on one GPU or striped over a process group.

Counterpart of caesar_yolo_tpu/parallel/sfinder.py (reference
inference.py:280-1287).  Tiles are grouped by shape and padded to
`batch_size`, and reach the device by one of three paths, chosen as the
reference chooses them (`_device_tiling_mode`):
  full    the mosaic is read once and shipped to the device once; windows
          are cut there (TileEngine.process_mosaic_async), so an
          overlapping grid ships no pixel twice.  Only this path can take
          the global statistics context (`preproc_context="global"`: the
          pipeline runs once over the whole mosaic).
  band    for mosaics past `device_tiling_max_bytes`: one full-width band
          per grid row, read and shipped by two workers one band ahead;
          a band whose read fails sends its tiles to the streaming path.
  stream  windowed reads in a thread pool, staged on the device in the
          feeding threads.
Every path keeps at most two device batches undrained, so memory stays
bounded whatever the mosaic size.  Each drained tile's result is appended
to a spool (flushed once a batch) that `resume=True` reads back after a
crash; the spool's first line is the grid signature, the reference's
own, so a spool of either package resumes in the other.  The host then
sorts the results by tile id, flags edge sources, stitches them across
tiles (parallel/stitch.py) and writes the JSON catalog and DS9 regions.
`profile_dir` records the tiled run with torch.profiler (a Chrome trace);
`save_tile_img` writes each predicted tile's raw window as FITS.  The
serial path (`run`) also takes PNG and JPEG images (utils/fits.py:
read_image), with the crop window honoured; tiled runs take FITS only, as
the reference's do.

Under a process group (parallel/mesh.py: one process per GPU, launched by
torchrun) a tiled run is the JAX SFinder's multi-process run: each rank
takes the tiles with tid % nproc == rank on whichever device-tiling path
its own tiles pick (on the full path every rank ships, and in the global
context preprocesses, the whole mosaic), spools them to its own file
(`.p{rank}` suffix; the stripe is part of the grid signature), and the
results come back to every rank by a chunked allgather of fixed-size byte
rounds (`gather_payload_bytes`), so every rank stitches the same catalog;
only rank 0 writes it.

A tiled run records spans (utils/trace.py) into its recorder, the CLI's
or its own: `sfinder.header`, `engine.prepare`, `detect` (with
`sfinder.read`, the engine's `engine.stage` and `engine.dispatch`,
`preprocess_mosaic` and one `sfinder.drain` a batch, whose child
`sfinder.drain_wait` is the copy of the batch's outputs to the host),
`edge_flagging`, `stitch` and `save`.  At the end of the run each name's
total, and the device-clock counter `engine.device_starved`, go into
`SFinderReport.phase_times` under that name, and `read_s` is the
`sfinder.read` total; the spans themselves are `SFinderReport.spans`.
A model with area attention (YOLO12) adds the calls its forwards made
during `detect`, `model.area_attn_fused` (K2) and `model.area_attn_plain`
(models/layers.py:area_attention).
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from caesar_yolo_tpu_torch import logger
from caesar_yolo_tpu_torch.detect.analyzer import Analyzer, AnalyzerOutputs
from caesar_yolo_tpu_torch.detect.merge import merge_detections
from caesar_yolo_tpu_torch.detect.predictor import Predictor
from caesar_yolo_tpu_torch.models.layers import area_attn_counts
from caesar_yolo_tpu_torch.outputs.catalog import (
    CLASS_COLOR_MAP_DS9_MOSAIC,
    CLASS_NAMES,
    make_json_results,
    make_objects,
    write_json,
)
from caesar_yolo_tpu_torch.outputs.ds9 import write_ds9_regions
from caesar_yolo_tpu_torch.parallel import mesh
from caesar_yolo_tpu_torch.parallel.engine import TileEngine
from caesar_yolo_tpu_torch.parallel.stitch import (
    flag_edge_sources,
    stitch_tile_sources,
)
from caesar_yolo_tpu_torch.utils.device import resolve_device
from caesar_yolo_tpu_torch.utils.fits import (
    beam_area_from_header,
    get_fits_header,
    read_fits_crop,
    read_image,
    write_fits,
)
from caesar_yolo_tpu_torch.utils.tiling import (
    TileWindow,
    generate_tiles,
    make_tile_windows,
    neighbor_table,
)
from caesar_yolo_tpu_torch.utils.trace import NULL, Recorder


@dataclass(frozen=True)
class SFinderConfig:
    """Frozen run configuration: the reference's SFinderConfig (the serial
    run's FITS image and plot outputs: save_img, draw_plot, save_plot,
    draw_class_label_in_caption)."""
    image_path: str = ""
    image_xmin: int = 0
    image_xmax: int = 0
    image_ymin: int = 0
    image_ymax: int = 0
    img_size: int = 640
    score_thr: float = 0.7
    iou_thr: float = 0.5
    pre_nms: int = 512
    merge_overlap_iou_thr_soft: float = 0.3
    merge_overlap_iou_thr_hard: float = 0.8
    split_image_in_tiles: bool = False
    tile_xsize: int = 256
    tile_ysize: int = 256
    tile_xstep: float = 1.0
    tile_ystep: float = 1.0
    max_ntasks_per_worker: int = 100
    batch_size: int = 8
    save_catalog: bool = True
    save_region: bool = True
    save_tile_catalog: bool = False
    save_tile_region: bool = False
    save_tile_img: bool = False   # timg_<image>_tid<k>.fits per tile
    save_img: bool = False
    draw_plot: bool = False
    save_plot: bool = False
    draw_class_label_in_caption: bool = True
    outfile_json: str = ""
    outfile_ds9: str = ""
    class_names: tuple = CLASS_NAMES
    profile_dir: str = ""      # write a torch.profiler trace of the run
    resume: bool = False       # resume a crashed tiled run from the spool
    spool_path: str = ""       # per-tile result spool (default: auto)
    # host->device tile transfer dtype (TileEngine.relay_dtype)
    relay_dtype: str = "float32"
    # device-resident tiling ("auto" | "on" | "off"; _device_tiling_mode)
    # and the largest mosaic or band it ships
    device_tiling: str = "auto"
    device_tiling_max_bytes: int = 2 * 1024 * 1024 * 1024
    # preprocessing statistics of tiled runs: "tile" (each tile's own
    # pixels, the reference's parity) or "global" (the whole mosaic's,
    # on the full device-resident path only; others fall back to "tile")
    preproc_context: str = "tile"
    # under a process group: the chunk size of the results' allgather; a
    # larger payload takes more rounds, never an error
    gather_payload_bytes: int = 8 * 1024 * 1024


@dataclass
class SFinderReport:
    """Run observability: timings and per-tile failures."""
    runtime_s: float = 0.0
    n_tiles: int = 0
    n_local_tiles: int = 0  # tiles this rank detected (its stripe)
    n_sources: int = 0
    max_inflight_batches: int = 0  # peak read futures + undrained batches
    read_s: float = 0.0     # the sfinder.read spans' total (worker sum)
    tiling_mode: str = ""   # "full", "band" or "stream" (the paths taken)
    h2d_bytes: int = 0      # pixel bytes shipped to the device
    n_resumed: int = 0      # tile results taken from the spool
    gather_rounds: int = 0  # rounds of the results' allgather (a group)
    gather_bytes: int = 0   # this rank's gathered payload
    phase_times: dict = field(default_factory=dict)  # seconds by span name
    tile_errors: list = field(default_factory=list)
    spans: list = field(default_factory=list)   # the run's trace.Span list


class SFinder:
    """Mosaic source finder on one device (this process's GPU unless
    `device` says otherwise; under a process group, one rank of a striped
    tiled run).  `model` is the port's YOLO with its weights loaded;
    `engine_kwargs` go to the TileEngine and the Predictor (e.g.
    compute_dtype).  `recorder` is the run's span recorder (utils/trace.py;
    the CLI passes the one holding its own spans), a new one if None.  The
    engine and the Predictor run predictor.prepare_model's inference model
    of `model`: `model` itself where it is one already (cli.run's model
    from npz weights, models/convert.py:build_prepared), else a copy."""

    def __init__(self, model, config: SFinderConfig, *, preprocessor=None,
                 engine_kwargs=None, predictor=None, engine=None,
                 device=None, recorder: Recorder | None = None):
        self.model = model
        self.config = config
        self.preprocessor = preprocessor
        self.engine_kwargs = dict(engine_kwargs or {})
        self.device = resolve_device(device)
        self.sources: dict = {"sources": []}
        self.recorder = Recorder() if recorder is None else recorder
        self.report = SFinderReport(spans=self.recorder.spans)
        self._engine = engine
        self._predictor = predictor
        base = os.path.basename(os.path.abspath(config.image_path))
        self.image_id = os.path.splitext(base)[0]
        self.header = None
        self.beam_info = None  # dx/dy/bmaj/bmin/pa/pixel_area/beam_area
        self.nx = self.ny = -1
        self.xmin = self.ymin = 0
        self.last_tile_results: list[dict] = []
        self._image_cache = None  # a PNG/JPEG decode, reused by run()

    def _crop(self) -> bool:
        cfg = self.config
        return (cfg.image_xmin >= 0 and cfg.image_xmax > 0
                and cfg.image_ymin >= 0 and cfg.image_ymax > 0)

    # -- image metadata ------------------------------------------------------

    def set_img_size_params(self) -> int:
        """Image size / crop range / beam area: from the FITS header, or
        from the decoded PNG/JPEG, whose decode `run` reuses (reference
        inference.py:354-477)."""
        cfg = self.config
        fits = os.path.splitext(cfg.image_path)[1] == ".fits"
        if fits:
            self.header = get_fits_header(cfg.image_path)
            if self.header is None:
                logger.error("Header read from image %s is None!",
                             cfg.image_path)
                return -1
        if self._crop():
            self.xmin, self.ymin = cfg.image_xmin, cfg.image_ymin
            self.xmax, self.ymax = cfg.image_xmax, cfg.image_ymax
            self.nx = self.xmax - self.xmin + 1
            self.ny = self.ymax - self.ymin + 1
        else:
            if fits:
                if "NAXIS1" not in self.header or "NAXIS2" not in self.header:
                    logger.error("NAXIS1/NAXIS2 missing in header!")
                    return -1
                self.nx = int(self.header["NAXIS1"])
                self.ny = int(self.header["NAXIS2"])
            else:
                res = read_image(cfg.image_path)
                if res is None:
                    return -1
                self._image_cache = res
                self.ny, self.nx = res[0].shape[:2]
            self.xmin, self.ymin = 0, 0
            self.xmax, self.ymax = self.nx - 1, self.ny - 1
        if self.header is not None:
            self.beam_info = beam_area_from_header(self.header)
        return 0

    def _read_serial_image(self):
        """The serial path's pixels: the FITS window, or the PNG/JPEG with
        the crop window cut from it -> array, or None (logged)."""
        cfg = self.config
        ext = os.path.splitext(cfg.image_path)[1]
        crop = self._crop()
        if ext == ".fits":
            # config crop bounds are INCLUSIVE; read_fits_crop's window is
            # exclusive, so serial and tiled runs cover the same pixels
            res = read_fits_crop(
                cfg.image_path, cfg.image_xmin,
                cfg.image_xmax + 1 if crop else cfg.image_xmax,
                cfg.image_ymin,
                cfg.image_ymax + 1 if crop else cfg.image_ymax,
                strip_deg_axis=True)
            if res is None:
                logger.error("Failed to read image %s!", cfg.image_path)
                return None
            return res[0]
        if ext not in (".png", ".jpg", ".jpeg"):
            logger.error("Unsupported image format (%s) given!", ext)
            return None
        res = (self._image_cache if self._image_cache is not None
               else read_image(cfg.image_path))
        if res is None:
            return None
        data = res[0]
        if crop:
            # the reference ignores the crop flags for PNG/JPEG
            # (inference.py:511-519), but the Analyzer offsets every
            # catalog position by the crop origin, so the window is cut
            # too, as the reference package does
            h, w = data.shape[:2]
            if cfg.image_xmax >= w or cfg.image_ymax >= h:
                logger.error("Crop window [%d:%d, %d:%d] exceeds image size "
                             "%dx%d!", cfg.image_xmin, cfg.image_xmax,
                             cfg.image_ymin, cfg.image_ymax, w, h)
                return None
            data = data[cfg.image_ymin:cfg.image_ymax + 1,
                        cfg.image_xmin:cfg.image_xmax + 1]
        return data

    # -- serial path ---------------------------------------------------------

    def run(self) -> int:
        """Whole-image (or crop) detection through the Analyzer
        (reference inference.py:485-552)."""
        t0 = time.time()
        if self.set_img_size_params() < 0:
            return -1
        cfg = self.config
        image_data = self._read_serial_image()
        if image_data is None:
            return -1

        if self._predictor is None:
            self._predictor = Predictor(
                self.model, img_size=cfg.img_size, score_thr=cfg.score_thr,
                iou_thr=cfg.iou_thr, pre_nms=cfg.pre_nms, device=self.device,
                **self.engine_kwargs)
        # every rank of a group runs the whole image; rank 0 writes
        master = mesh.process_index() == 0
        outputs = AnalyzerOutputs(
            write_json=cfg.save_catalog and master,
            write_ds9=cfg.save_region and master,
            save_img=cfg.save_img and master, draw=cfg.draw_plot and master,
            save_plot=cfg.save_plot,
            draw_class_label_in_caption=cfg.draw_class_label_in_caption,
            outfile_json=cfg.outfile_json or f"out_{self.image_id}.json",
            outfile_ds9=cfg.outfile_ds9 or f"out_{self.image_id}.reg")
        analyzer = Analyzer(
            self._predictor, preprocessor=self.preprocessor,
            soft_merge_thr=cfg.merge_overlap_iou_thr_soft,
            hard_merge_thr=cfg.merge_overlap_iou_thr_hard,
            outputs=outputs, class_names=cfg.class_names)
        rc = analyzer.predict(image_data, self.image_id,
                              xmin=self.xmin, ymin=self.ymin)
        self.report.runtime_s = time.time() - t0
        if rc < 0:
            logger.error("Failed to run model prediction on image %s!",
                         cfg.image_path)
            return -1
        n = len(analyzer.detections)
        self.report.n_sources = n
        self.sources = {"sources": analyzer.results["objs"]}
        logger.info("#%d objects found in image %s (%.2fs)", n,
                    cfg.image_path, self.report.runtime_s)
        return 0

    # -- tiled path ----------------------------------------------------------

    def run_tiled(self) -> int:
        """Tile the mosaic, run batched inference, stitch, save
        (reference inference.py:578-658 run_parallel).  Completed tile
        results are spooled as they arrive, and resume=True skips the tiles
        a crashed run finished.  With profile_dir set, the run is recorded
        by torch.profiler and written there as a Chrome trace
        (<image>.trace.json; the reference writes a jax.profiler trace),
        the run's spans among its events."""
        try:
            if not self.config.profile_dir:
                return self._run_tiled_impl()
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            with profile(activities=activities) as prof:
                self.recorder.profiling = True
                try:
                    rc = self._run_tiled_impl()
                finally:
                    self.recorder.profiling = False
            os.makedirs(self.config.profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                self.config.profile_dir, f"{self.image_id}.trace.json"))
            return rc
        finally:
            self.report.phase_times.update(self.recorder.totals())
            self.report.read_s = self.report.phase_times.get("sfinder.read",
                                                             0.0)

    def _run_tiled_impl(self) -> int:
        t0 = time.time()
        cfg = self.config
        rec = self.recorder
        if os.path.splitext(cfg.image_path)[1] != ".fits":
            logger.error("Only FITS images are supported in tiled runs!")
            return -1
        with rec.span("sfinder.header"):
            if self.set_img_size_params() < 0:
                return -1
            grid = generate_tiles(self.xmin, self.xmax, self.ymin, self.ymax,
                                  cfg.tile_xsize, cfg.tile_ysize,
                                  cfg.tile_xstep, cfg.tile_ystep)
            if grid is None:
                return -1
            tiles = make_tile_windows(grid)
        per_worker = -(-len(tiles) // mesh.process_count())
        if per_worker > cfg.max_ntasks_per_worker:
            # the reference's guard (inference.py:1150-1160), a GPU a rank
            logger.error(
                "Too many tasks per worker (%d > %d): increase tile size, "
                "processes, or max_ntasks_per_worker!", per_worker,
                cfg.max_ntasks_per_worker)
            return -1
        self.report.n_tiles = len(tiles)
        logger.info("Split image %s into %d tiles (%dx%d, step %.2f/%.2f)",
                    self.image_id, len(tiles), cfg.tile_xsize,
                    cfg.tile_ysize, cfg.tile_xstep, cfg.tile_ystep)

        if self._engine is None:
            # the weights' copy, BatchNorm fold, cast and move to the
            # device; none of it for a model prepared already
            with rec.span("engine.prepare"):
                self._engine = TileEngine(
                    self.model, preprocessor=self.preprocessor,
                    img_size=cfg.img_size, score_thr=cfg.score_thr,
                    iou_thr=cfg.iou_thr, pre_nms=cfg.pre_nms,
                    relay_dtype=cfg.relay_dtype, device=self.device,
                    **self.engine_kwargs)

        self._engine.recorder = rec
        attn_before = area_attn_counts()
        try:
            with rec.span("detect"):
                tile_results = self._detect_tiles(self._engine, tiles)
        finally:
            self._engine.recorder = NULL
            # the area-attention calls of this run's forwards (YOLO12)
            moved = {k: n - attn_before[k]
                     for k, n in area_attn_counts().items()}
            if any(moved.values()):
                for k, n in moved.items():
                    rec.add(k, n)

        # edge flagging (reference inference.py:663-726)
        with rec.span("edge_flagging"):
            tile_by_id = {t.tid: t for t in tiles}
            for res in tile_results:
                nb = [tile_by_id[tid] for tid in res["neighborTileIds"]]
                flag_edge_sources(res["objs"], tile_by_id[res["tileId"]], nb)

        # stitch (reference inference.py:731-931)
        with rec.span("stitch"):
            self.sources = stitch_tile_sources(tile_results)
        self.last_tile_results = tile_results

        with rec.span("save"):
            self.save()
        self.report.runtime_s = time.time() - t0
        self.report.n_sources = len(self.sources["sources"])
        logger.info("Run completed in %.2f seconds (%d tiles, %d sources)",
                    self.report.runtime_s, len(tiles),
                    self.report.n_sources)
        return 0

    # -- the result spool ----------------------------------------------------

    def _spool_file(self) -> str:
        """The spool's path: spool_path, else .<image>.tilespool.jsonl in
        the working directory, with a .p{rank} suffix under several
        processes (an explicit spool_path too: ranks sharing one file would
        interleave their appends)."""
        base = (self.config.spool_path
                or f".{self.image_id}.tilespool.jsonl")
        if mesh.process_count() > 1:
            root, ext = os.path.splitext(base)
            base = f"{root}.p{mesh.process_index()}{ext}"
        return base

    def _grid_signature(self) -> dict:
        """Everything that changes what a spooled tile result means (the
        reference's signature, sfinder.py:415-436): a resume under another
        grid, image or detection setting would stitch stale windows into
        the new run, and one under another stripe [rank, nproc] would keep
        tiles that another rank now recomputes."""
        cfg = self.config
        return {"image": cfg.image_path,
                "stripe": [mesh.process_index(), mesh.process_count()],
                "tile_xsize": cfg.tile_xsize, "tile_ysize": cfg.tile_ysize,
                "tile_xstep": cfg.tile_xstep, "tile_ystep": cfg.tile_ystep,
                "crop": [cfg.image_xmin, cfg.image_xmax,
                         cfg.image_ymin, cfg.image_ymax],
                "img_size": cfg.img_size, "score_thr": cfg.score_thr,
                "iou_thr": cfg.iou_thr, "pre_nms": cfg.pre_nms}

    def _load_spool(self, sig: dict) -> dict:
        """tid -> tile result of a previous crashed run: empty when the
        spool is missing, unreadable or written under another signature
        (or none).  A record torn by a crash mid-write is dropped, every
        complete one kept."""
        done = {}
        path = self._spool_file()
        if not os.path.exists(path):
            return done
        try:
            f = open(path)
        except OSError as e:
            logger.warning("Ignoring unreadable spool %s (%s)", path, e)
            return done
        with f:
            try:
                head = json.loads(f.readline() or "null")
            except ValueError:
                head = None
            if not isinstance(head, dict) or head.get("gridSig") != sig:
                logger.warning(
                    "Ignoring spool %s: it was written under a different "
                    "tiling/detection configuration (resume requires "
                    "identical settings)", path)
                return done
            for line in f:
                try:
                    tr = json.loads(line)
                    done[tr["tileId"]] = tr
                except (ValueError, KeyError, TypeError):
                    logger.warning("Dropping a torn record in spool %s (a "
                                   "crash mid-write)", path)
        logger.info("Resuming: %d tile results loaded from %s", len(done),
                    path)
        return done

    # -- device-resident tiling ----------------------------------------------

    def _device_tiling_mode(self, engine: TileEngine, groups) -> str | None:
        """"full" (the whole mosaic to the device once), "band" (one
        full-width band per grid row: for mosaics past the cap, only the
        vertical overlap re-ships) or None (stream windowed reads), as the
        reference decides (sfinder.py:493-533): "auto" compares the bytes
        each path would ship for the tiles still to do (after the spool's
        skips) in the relay dtype."""
        cfg = self.config
        if cfg.device_tiling == "off" or not groups:
            return None
        if cfg.device_tiling == "on":
            return "full"
        item = engine.relay_dtype.itemsize
        window_bytes = sum(len(g) * h * w
                           for (h, w), g in groups.items()) * item
        full_bytes = self.nx * self.ny * item
        if (full_bytes <= cfg.device_tiling_max_bytes
                and full_bytes <= window_bytes):
            return "full"
        rows = {(t.ymin, t.ymax) for g in groups.values() for t in g}
        band_bytes = sum(self.nx * (y1 - y0) for y0, y1 in rows) * item
        max_band = max(self.nx * (y1 - y0) for y0, y1 in rows) * item
        if (max_band <= cfg.device_tiling_max_bytes
                and band_bytes <= window_bytes):
            logger.info(
                "Device tiling: banded (bands %.1f MB <= windows %.1f MB; "
                "full mosaic %.1f MB)", band_bytes / 1e6, window_bytes / 1e6,
                full_bytes / 1e6)
            return "band"
        logger.info(
            "Device tiling skipped: windowed reads ship fewer bytes "
            "(windows %.1f MB vs mosaic %.1f MB / bands %.1f MB, cap %d)",
            window_bytes / 1e6, full_bytes / 1e6, band_bytes / 1e6,
            cfg.device_tiling_max_bytes)
        return None

    def _load_device_mosaic(self):
        """The host mosaic (crop) f32 [ny, nx] for device-resident tiling,
        or None when it is unreadable (the tiles then stream)."""
        cfg = self.config
        with self.recorder.span("sfinder.read"):
            res = read_fits_crop(cfg.image_path, self.xmin, self.xmax + 1,
                                 self.ymin, self.ymax + 1,
                                 strip_deg_axis=True)
        if res is None or np.asarray(res[0]).ndim != 2:
            logger.warning("Device tiling skipped: full mosaic read failed; "
                           "streaming windowed reads instead")
            return None
        logger.info("Device tiling: shipping the %dx%d mosaic to the device "
                    "once", self.ny, self.nx)
        return np.asarray(res[0], np.float32)

    # -- tile detection ------------------------------------------------------

    def _detect_tiles(self, engine: TileEngine, tiles: list[TileWindow]):
        """Shape-grouped, batch-padded, prefetched tile detection on the
        path _device_tiling_mode picks (reference sfinder.py:551-874), with
        the result spool."""
        cfg = self.config
        sig = self._grid_signature()
        done = self._load_spool(sig) if cfg.resume else {}
        self.report.n_resumed = len(done)
        # the stripe: this rank takes tid % nproc == rank (the reference's
        # round-robin, inference.py:1008-1029)
        nproc, rank = mesh.process_count(), mesh.process_index()
        groups: dict[tuple, list[TileWindow]] = {}
        for t in tiles:
            if t.tid in done or t.tid % nproc != rank:
                continue
            self.report.n_local_tiles += 1
            groups.setdefault((t.height, t.width), []).append(t)

        path = self._spool_file()
        torn = False
        if done:    # a crash may have cut the last record short
            with open(path, "rb") as f:
                f.seek(-1, os.SEEK_END)
                torn = f.read(1) != b"\n"
        results = []
        tile_imgs: dict[int, np.ndarray] = {}   # tid -> raw window
        # append only onto a spool whose signature matched; otherwise start
        # afresh with the signature as its first record
        with open(path, "a" if done else "w") as spool:
            if not done:
                spool.write(json.dumps({"gridSig": sig}) + "\n")
            elif torn:
                spool.write("\n")
            spool.flush()

            def drain(item):
                batch, kept_tiles, outs = item
                with self.recorder.span("sfinder.drain", batch):
                    # the host blocks here until the batch's copies are done
                    with self.recorder.span("sfinder.drain_wait", batch):
                        host = outs()
                    self.recorder.batch_done(batch)
                    unpack(kept_tiles, *host)

            def unpack(kept_tiles, boxes, scores, cls, valid, tile_ok, ndrop):
                for k, t in enumerate(kept_tiles):
                    img = tile_imgs.pop(t.tid, None)
                    if ndrop[k]:
                        logger.warning(
                            "Tile %d: NMS pre-filter dropped %d "
                            "above-threshold candidates (raise pre_nms=%d "
                            "for this field)", t.tid, int(ndrop[k]),
                            cfg.pre_nms)
                    if not tile_ok[k]:
                        continue
                    tr = self._tile_objects(
                        t, boxes[k][valid[k]], scores[k][valid[k]],
                        cls[k][valid[k]])
                    if img is not None:
                        write_fits(img,
                                   f"timg_{self.image_id}_tid{t.tid}.fits")
                    results.append(tr)
                    spool.write(json.dumps(tr) + "\n")
                spool.flush()

            flow = _Inflight(drain, self.report, engine.to_host_async)
            paths = []
            mode = self._device_tiling_mode(engine, groups)
            mosaic_np = None
            if mode == "full":
                mosaic_np = self._load_device_mosaic()
                if mosaic_np is None:
                    mode = None
            global_ctx = cfg.preproc_context == "global"
            if global_ctx and mode != "full":
                logger.warning(
                    "preproc_context='global' needs the device-resident "
                    "mosaic path (device_tiling mode=%s here); falling back "
                    "to per-tile statistics context", mode)
                global_ctx = False
            if mode == "full":
                paths.append("full")
                mosaic_dev = engine.put_mosaic(mosaic_np)
                self.report.h2d_bytes += (mosaic_np.size
                                          * engine.relay_dtype.itemsize)
                if not cfg.save_tile_img:
                    mosaic_np = None    # the host copy is done with
                self._full_path(engine, groups, mosaic_dev, mosaic_np,
                                global_ctx, flow, tile_imgs)
                groups = {}
            elif mode == "band":
                paths.append("band")
                groups = self._band_path(engine, groups, flow, tile_imgs)
            if groups:
                paths.append("stream")
                self._stream_path(engine, groups, flow, tile_imgs)
            self.report.tiling_mode = "+".join(paths)
        results.extend(done.values())
        # canonical tileId order: the stitched catalog (S1..SN naming,
        # component traversal) is a pure function of the tile-result set,
        # however many of them came from the spool
        results.sort(key=lambda tr: tr["tileId"])
        if mesh.distributed():
            results = self._gather(results)
        nb = neighbor_table(tiles)
        for tr in results:
            tr["neighborTileIds"] = nb[tr["tileId"]]
        try:        # the run finished: the spool is no longer needed
            os.remove(path)
        except OSError:
            pass
        return results

    def _gather(self, local_results: list[dict]) -> list[dict]:
        """Every rank's tile results, sorted by tile id, on every rank
        (the JAX SFinder's _gather_multihost): each rank's JSON through
        mesh.allgather_bytes, so every rank stitches the same catalog."""
        blob = json.dumps(local_results).encode()
        rows, self.report.gather_rounds = mesh.allgather_bytes(
            blob, self.config.gather_payload_bytes)
        self.report.gather_bytes = len(blob)
        merged = [tr for row in rows if row for tr in json.loads(row)]
        merged.sort(key=lambda tr: tr["tileId"])
        return merged

    def _origins(self, tile_batch, row0: int) -> np.ndarray:
        """[batch_size, 2] window corners (row, column) in an array whose
        first row is image row row0 and first column the crop's; padding
        slots take (0, 0)."""
        origins = np.zeros((self.config.batch_size, 2), np.int64)
        for k, t in enumerate(tile_batch):
            origins[k] = (t.ymin - row0, t.xmin - self.xmin)
        return origins

    def _full_path(self, engine, groups, mosaic_dev, mosaic_np, global_ctx,
                   flow, tile_imgs):
        """Windows cut from the device-resident mosaic (reference
        sfinder.py:653-696; mosaic_np, the host copy, is kept only for
        save_tile_img).  global_ctx: the pipeline runs once over the whole
        mosaic and the windows skip it."""
        cfg = self.config
        if global_ctx:
            with self.recorder.span("preprocess_mosaic"):
                mosaic_dev, ok = engine.preprocess_mosaic(mosaic_dev)
            if not ok:
                logger.warning(
                    "Whole-mosaic preprocessing flagged the image invalid "
                    "(degenerate statistics); per-tile guards will reject "
                    "affected tiles")
        for (h, w), group in groups.items():
            for i in range(0, len(group), cfg.batch_size):
                tile_batch = group[i:i + cfg.batch_size]
                if mosaic_np is not None:
                    for t in tile_batch:
                        tile_imgs[t.tid] = mosaic_np[
                            t.ymin - self.ymin:t.ymax - self.ymin,
                            t.xmin - self.xmin:t.xmax - self.xmin]
                flow.push(tile_batch, engine.process_mosaic_async(
                    mosaic_dev, self._origins(tile_batch, self.ymin), (h, w),
                    preprocessed=global_ctx, batch=flow.dispatched))
        flow.finish()

    def _band_path(self, engine, groups, flow, tile_imgs) -> dict:
        """One full-width band per grid row (a grid row's tiles share their
        rows, so its band covers them exactly) crosses to the device; two
        workers read and ship the bands one ahead (reference
        sfinder.py:697-779).  Returns the groups of the tiles whose band
        could not be read, for the streaming path."""
        cfg = self.config
        item = engine.relay_dtype.itemsize
        bands: dict = {}
        for (h, w), group in groups.items():
            for t in group:
                bands.setdefault((t.ymin, t.ymax), {}).setdefault(
                    (h, w), []).append(t)
        keys = sorted(bands)
        leftover: dict = {}

        def read_band(bk):
            """Worker-side band read and device put, so that the next band
            ships while the current band's batches compute."""
            with self.recorder.span("sfinder.read"):
                res = read_fits_crop(cfg.image_path, self.xmin,
                                     self.xmax + 1, bk[0], bk[1],
                                     strip_deg_axis=True)
                if res is None or np.asarray(res[0]).ndim != 2:
                    return None
                band_np = np.asarray(res[0], np.float32)
            band_dev = engine.put_mosaic(band_np)
            return (band_np if cfg.save_tile_img else None, band_dev,
                    band_np.size * item)

        with ThreadPoolExecutor(max_workers=2) as pool:
            futs: deque = deque((bk, pool.submit(read_band, bk))
                                for bk in keys[:2])
            nxt = len(futs)
            while futs:
                bk, fut = futs.popleft()
                staged = fut.result()
                if nxt < len(keys):
                    futs.append((keys[nxt], pool.submit(read_band,
                                                        keys[nxt])))
                    nxt += 1
                if staged is None:
                    for shape, ts in bands[bk].items():
                        leftover.setdefault(shape, []).extend(ts)
                    logger.warning("Band read failed at rows [%d,%d); "
                                   "falling back to windowed reads for its "
                                   "tiles", *bk)
                    continue
                band_np, band_dev, nbytes = staged
                self.report.h2d_bytes += nbytes
                for (h, w), ts in bands[bk].items():
                    for i in range(0, len(ts), cfg.batch_size):
                        tile_batch = ts[i:i + cfg.batch_size]
                        if band_np is not None:
                            for t in tile_batch:
                                tile_imgs[t.tid] = band_np[
                                    :, t.xmin - self.xmin:t.xmax - self.xmin]
                        flow.push(tile_batch, engine.process_mosaic_async(
                            band_dev, self._origins(tile_batch, bk[0]),
                            (h, w), batch=flow.dispatched),
                            waiting=len(futs))
            flow.finish()
        return leftover

    def _stream_path(self, engine, groups, flow, tile_imgs):
        """Windowed reads in a thread pool, each batch staged on the device
        by its feeding thread, at most two reads ahead (reference
        sfinder.py:780-854)."""
        cfg = self.config
        batch = cfg.batch_size
        item = engine.relay_dtype.itemsize

        def read_tile(t: TileWindow):
            res = read_fits_crop(cfg.image_path, t.xmin, t.xmax,
                                 t.ymin, t.ymax, strip_deg_axis=True)
            if res is None:
                return None
            return np.asarray(res[0], np.float32)[:, :, None]

        with ThreadPoolExecutor(max_workers=8) as pool:
            for (h, w), group in groups.items():
                batches = [group[i:i + batch]
                           for i in range(0, len(group), batch)]

                def read_and_stage(tile_batch, h=h, w=w):
                    """Worker-side read, batch assembly and device put, so
                    that staging batch N+1 overlaps the device computing
                    batch N."""
                    with self.recorder.span("sfinder.read"):
                        datas = list(pool.map(read_tile, tile_batch))
                        ok_idx = [i for i, d in enumerate(datas)
                                  if d is not None]
                        arr = np.zeros((batch, h, w, 1), np.float32)
                        for k, i in enumerate(ok_idx):
                            arr[k] = datas[i]
                    dev = engine.put_tiles(arr)
                    keep = datas if cfg.save_tile_img else None
                    return ok_idx, keep, dev

                futures: deque = deque()
                next_batch = 0

                def submit_read():
                    nonlocal next_batch
                    if next_batch < len(batches):
                        futures.append((batches[next_batch], pool.submit(
                            read_and_stage, batches[next_batch])))
                        next_batch += 1

                submit_read()
                submit_read()
                while futures:
                    tile_batch, fut = futures.popleft()
                    ok_idx, datas, dev = fut.result()
                    submit_read()
                    self.report.h2d_bytes += batch * h * w * item
                    ok_set = set(ok_idx)
                    for i, t in enumerate(tile_batch):
                        if i not in ok_set:
                            self.report.tile_errors.append(
                                (t.tid, "read failed"))
                            logger.error("Failed to read tile %d, skipping",
                                         t.tid)
                    if datas is not None:
                        for i in ok_idx:
                            tile_imgs[tile_batch[i].tid] = datas[i][:, :, 0]
                    flow.push([tile_batch[i] for i in ok_idx],
                              engine.process_async(
                                  dev, batch=flow.dispatched),
                              waiting=len(futures))
                flow.finish()

    def _tile_objects(self, t: TileWindow, boxes, scores, cls):
        cfg = self.config
        boxes, scores, cls = merge_detections(
            boxes, scores, cls,
            soft_thr=cfg.merge_overlap_iou_thr_soft,
            hard_thr=cfg.merge_overlap_iou_thr_hard)
        objs = make_objects(boxes, scores, cls,
                            image_shape=(t.height, t.width),
                            xmin=t.xmin, ymin=t.ymin,
                            name_tag=f"t{t.tid}",
                            class_names=cfg.class_names)
        if cfg.save_tile_catalog:
            write_json(make_json_results(self.image_id, objs),
                       f"catalog_{self.image_id}_tid{t.tid}.json")
        if cfg.save_tile_region:
            write_ds9_regions(objs,
                              f"catalog_{self.image_id}_tid{t.tid}.reg")
        return {"objs": objs, "tileId": t.tid,
                "workerId": mesh.process_index(),
                "neighborTileIds": [],
                "xmin": t.xmin, "xmax": t.xmax,
                "ymin": t.ymin, "ymax": t.ymax}

    # -- output --------------------------------------------------------------

    def save(self):
        """Write the mosaic catalog and DS9 regions, from rank 0 only
        (reference inference.py:641-648, 1167-1287): every rank holds the
        whole stitched catalog, and ranks writing one path would race."""
        if mesh.process_index() != 0:
            return
        cfg = self.config
        if cfg.save_catalog:
            out = cfg.outfile_json or f"catalog_{self.image_id}.json"
            write_json(self.sources, out)
            logger.info("Wrote catalog %s", out)
        if cfg.save_region:
            out = cfg.outfile_ds9 or f"ds9_{self.image_id}.reg"
            # mosaic-level palette differs from the per-tile Analyzer map
            # (reference inference.py:334-342)
            write_ds9_regions(self.sources["sources"], out,
                              color_map=CLASS_COLOR_MAP_DS9_MOSAIC)
            logger.info("Wrote regions %s", out)


class _Inflight:
    """Device batches dispatched and not yet drained: the oldest is drained
    once three wait, so the host unpacks batch N while the device computes
    N + 1 and N + 2 (the reference's loops).  Each batch's outputs start
    for the host as it is queued (`to_host`, TileEngine.to_host_async), so
    its drain waits for that batch alone.  Batches are numbered in the
    order they are dispatched, and drained in that order: `dispatched`
    is the index of the next one."""

    def __init__(self, drain, report: SFinderReport, to_host):
        self.pending: deque = deque()
        self.drain = drain
        self.report = report
        self.to_host = to_host
        self.dispatched = 0

    def push(self, kept_tiles, outs, waiting: int = 0):
        """Queue the dispatched batch number `dispatched` (its device
        outputs `outs`); `waiting` reads or bands are in flight beside it
        (counted in report.max_inflight_batches)."""
        self.pending.append((self.dispatched, list(kept_tiles),
                             self.to_host(outs)))
        self.dispatched += 1
        self.report.max_inflight_batches = max(
            self.report.max_inflight_batches, waiting + len(self.pending))
        if len(self.pending) > 2:
            self.drain(self.pending.popleft())

    def finish(self):
        while self.pending:
            self.drain(self.pending.popleft())
