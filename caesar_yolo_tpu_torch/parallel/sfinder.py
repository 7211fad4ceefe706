"""Mosaic-scale source finding on one GPU: tiling, batched inference, edge
handling, stitching, catalog output.

Counterpart of caesar_yolo_tpu/parallel/sfinder.py (reference
inference.py:280-1287), with its streaming windowed-read path: tile
windows are read from the FITS file by a thread pool, grouped by shape,
padded to `batch_size` and staged on the device in the feeding threads,
with at most two reads and two device batches in flight, so memory stays
bounded whatever the mosaic size.  The host then merges each tile's
detections, sorts the results by tile id, flags edge sources and
stitches them across tiles (parallel/stitch.py), and writes the JSON
catalog and DS9 regions.

Not ported yet (ROADMAP.md, Queue 1 items 5-7): device-resident and
banded tiling (`device_tiling="on"` raises NotImplementedError; "auto"
takes the streaming path), `preproc_context="global"` (raises), the
result spool and resume, the profiler trace, tile image dumps, plots,
PNG/JPEG input and multi-GPU runs.
"""

from __future__ import annotations

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
from caesar_yolo_tpu_torch.outputs.catalog import (
    CLASS_COLOR_MAP_DS9_MOSAIC,
    CLASS_NAMES,
    make_json_results,
    make_objects,
    write_json,
)
from caesar_yolo_tpu_torch.outputs.ds9 import write_ds9_regions
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
)
from caesar_yolo_tpu_torch.utils.tiling import (
    TileWindow,
    generate_tiles,
    make_tile_windows,
    neighbor_table,
)

ROADMAP = "ROADMAP.md, Queue 1"


@dataclass(frozen=True)
class SFinderConfig:
    """Frozen run configuration: the reference's SFinderConfig without
    the fields of features not ported yet (plots, image dumps, spool and
    resume, profiler trace), which the CLI refuses.  `device_tiling="on"`
    and `preproc_context="global"` are refused here."""
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
    outfile_json: str = ""
    outfile_ds9: str = ""
    class_names: tuple = CLASS_NAMES
    # host->device tile transfer dtype (TileEngine.relay_dtype)
    relay_dtype: str = "float32"
    # "auto" and "off" stream windowed reads; "on" is not ported
    device_tiling: str = "auto"
    preproc_context: str = "tile"


@dataclass
class SFinderReport:
    """Run observability: timings and per-tile failures."""
    runtime_s: float = 0.0
    n_tiles: int = 0
    n_local_tiles: int = 0
    n_sources: int = 0
    max_inflight_batches: int = 0  # peak read futures + undrained batches
    read_s: float = 0.0     # wall spent in windowed reads (worker sum)
    h2d_put_s: float = 0.0  # wall spent staging batches (worker sum)
    drain_s: float = 0.0    # main thread waiting on and unpacking results
    phase_times: dict = field(default_factory=dict)
    tile_errors: list = field(default_factory=list)


class SFinder:
    """Mosaic source finder on one device (CUDA unless `device` says
    otherwise).  `model` is the port's YOLO with its weights loaded;
    `engine_kwargs` go to the TileEngine and the Predictor (e.g.
    compute_dtype)."""

    def __init__(self, model, config: SFinderConfig, *, preprocessor=None,
                 engine_kwargs=None, predictor=None, engine=None,
                 device=None):
        if config.device_tiling == "on" or config.preproc_context != "tile":
            raise NotImplementedError(
                f"not ported yet: device_tiling={config.device_tiling!r}, "
                f"preproc_context={config.preproc_context!r} ({ROADMAP})")
        self.model = model
        self.config = config
        self.preprocessor = preprocessor
        self.engine_kwargs = dict(engine_kwargs or {})
        self.device = resolve_device(device)
        self.sources: dict = {"sources": []}
        self.report = SFinderReport()
        self._engine = engine
        self._predictor = predictor
        base = os.path.basename(os.path.abspath(config.image_path))
        self.image_id = os.path.splitext(base)[0]
        self.header = None
        self.beam_info = None  # dx/dy/bmaj/bmin/pa/pixel_area/beam_area
        self.nx = self.ny = -1
        self.xmin = self.ymin = 0
        self.last_tile_results: list[dict] = []

    def _crop(self) -> bool:
        cfg = self.config
        return (cfg.image_xmin >= 0 and cfg.image_xmax > 0
                and cfg.image_ymin >= 0 and cfg.image_ymax > 0)

    def _is_fits(self) -> bool:
        ext = os.path.splitext(self.config.image_path)[1]
        if ext != ".fits":
            logger.error("Only FITS images are supported by the port (got "
                         "%s; PNG/JPEG input waits, %s)", ext, ROADMAP)
            return False
        return True

    # -- image metadata ------------------------------------------------------

    def set_img_size_params(self) -> int:
        """Image size / crop range / beam area from the FITS header
        (reference inference.py:354-477)."""
        cfg = self.config
        if not self._is_fits():
            return -1
        self.header = get_fits_header(cfg.image_path)
        if self.header is None:
            logger.error("Header read from image %s is None!", cfg.image_path)
            return -1
        if self._crop():
            self.xmin, self.ymin = cfg.image_xmin, cfg.image_ymin
            self.xmax, self.ymax = cfg.image_xmax, cfg.image_ymax
            self.nx = self.xmax - self.xmin + 1
            self.ny = self.ymax - self.ymin + 1
        else:
            if "NAXIS1" not in self.header or "NAXIS2" not in self.header:
                logger.error("NAXIS1/NAXIS2 missing in header!")
                return -1
            self.nx = int(self.header["NAXIS1"])
            self.ny = int(self.header["NAXIS2"])
            self.xmin, self.ymin = 0, 0
            self.xmax, self.ymax = self.nx - 1, self.ny - 1
        self.beam_info = beam_area_from_header(self.header)
        return 0

    # -- serial path ---------------------------------------------------------

    def run(self) -> int:
        """Whole-image (or crop) detection through the Analyzer
        (reference inference.py:485-552)."""
        t0 = time.time()
        if self.set_img_size_params() < 0:
            return -1
        cfg = self.config
        # config crop bounds are INCLUSIVE; read_fits_crop's window is
        # exclusive, so serial and tiled runs cover the same pixels
        crop = self._crop()
        res = read_fits_crop(
            cfg.image_path, cfg.image_xmin,
            cfg.image_xmax + 1 if crop else cfg.image_xmax, cfg.image_ymin,
            cfg.image_ymax + 1 if crop else cfg.image_ymax,
            strip_deg_axis=True)
        if res is None:
            logger.error("Failed to read image %s!", cfg.image_path)
            return -1
        image_data = res[0]

        if self._predictor is None:
            self._predictor = Predictor(
                self.model, img_size=cfg.img_size, score_thr=cfg.score_thr,
                iou_thr=cfg.iou_thr, pre_nms=cfg.pre_nms, device=self.device,
                **self.engine_kwargs)
        outputs = AnalyzerOutputs(
            write_json=cfg.save_catalog, write_ds9=cfg.save_region,
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
        (reference inference.py:578-658 run_parallel)."""
        t0 = time.time()
        cfg = self.config
        if self.set_img_size_params() < 0:
            return -1
        grid = generate_tiles(self.xmin, self.xmax, self.ymin, self.ymax,
                              cfg.tile_xsize, cfg.tile_ysize,
                              cfg.tile_xstep, cfg.tile_ystep)
        if grid is None:
            return -1
        tiles = make_tile_windows(grid)
        if len(tiles) > cfg.max_ntasks_per_worker:
            # the reference's guard (inference.py:1150-1160), one device
            logger.error(
                "Too many tasks per worker (%d > %d): increase tile size or "
                "max_ntasks_per_worker!", len(tiles),
                cfg.max_ntasks_per_worker)
            return -1
        self.report.n_tiles = len(tiles)
        logger.info("Split image %s into %d tiles (%dx%d, step %.2f/%.2f)",
                    self.image_id, len(tiles), cfg.tile_xsize,
                    cfg.tile_ysize, cfg.tile_xstep, cfg.tile_ystep)
        if cfg.device_tiling == "auto":
            logger.info("Device tiling: the port streams windowed reads "
                        "(device-resident tiling is not ported yet)")

        if self._engine is None:
            self._engine = TileEngine(
                self.model, preprocessor=self.preprocessor,
                img_size=cfg.img_size, score_thr=cfg.score_thr,
                iou_thr=cfg.iou_thr, pre_nms=cfg.pre_nms,
                relay_dtype=cfg.relay_dtype, device=self.device,
                **self.engine_kwargs)

        t_detect = time.time()
        tile_results = self._detect_tiles(self._engine, tiles)
        self.report.phase_times["detect"] = time.time() - t_detect

        # edge flagging (reference inference.py:663-726)
        t_edge = time.time()
        tile_by_id = {t.tid: t for t in tiles}
        for tr in tile_results:
            nb = [tile_by_id[tid] for tid in tr["neighborTileIds"]]
            flag_edge_sources(tr["objs"], tile_by_id[tr["tileId"]], nb)
        self.report.phase_times["edge_flagging"] = time.time() - t_edge

        # stitch (reference inference.py:731-931)
        t_stitch = time.time()
        self.sources = stitch_tile_sources(tile_results)
        self.report.phase_times["stitch"] = time.time() - t_stitch
        self.last_tile_results = tile_results

        t_save = time.time()
        self.save()
        self.report.phase_times["save"] = time.time() - t_save
        self.report.runtime_s = time.time() - t0
        self.report.n_sources = len(self.sources["sources"])
        logger.info("Run completed in %.2f seconds (%d tiles, %d sources)",
                    self.report.runtime_s, len(tiles),
                    self.report.n_sources)
        return 0

    def _detect_tiles(self, engine: TileEngine, tiles: list[TileWindow]):
        """Shape-grouped, batch-padded, prefetched tile detection (the
        reference's streaming windowed-read path, sfinder.py:780-854)."""
        cfg = self.config
        batch = cfg.batch_size
        groups: dict[tuple, list[TileWindow]] = {}
        for t in tiles:
            self.report.n_local_tiles += 1
            groups.setdefault((t.height, t.width), []).append(t)

        def read_tile(t: TileWindow):
            res = read_fits_crop(cfg.image_path, t.xmin, t.xmax,
                                 t.ymin, t.ymax, strip_deg_axis=True)
            if res is None:
                return None
            return np.asarray(res[0], np.float32)[:, :, None]

        results = []

        def drain(item):
            t_drain = time.time()
            kept_tiles, outs = item
            boxes, scores, cls, valid, tile_ok, ndrop = (
                o.cpu().numpy() for o in outs)
            for k, t in enumerate(kept_tiles):
                if ndrop[k]:
                    logger.warning(
                        "Tile %d: NMS pre-filter dropped %d above-threshold "
                        "candidates (raise pre_nms=%d for this field)",
                        t.tid, int(ndrop[k]), cfg.pre_nms)
                if not tile_ok[k]:
                    continue
                results.append(self._tile_objects(
                    t, boxes[k][valid[k]], scores[k][valid[k]],
                    cls[k][valid[k]]))
            self.report.drain_s += time.time() - t_drain

        with ThreadPoolExecutor(max_workers=8) as pool:
            for (h, w), group in groups.items():
                batches = [group[i:i + batch]
                           for i in range(0, len(group), batch)]

                def read_and_stage(tile_batch, h=h, w=w):
                    """Worker-side read, batch assembly and device put, so
                    that staging batch N+1 overlaps the device computing
                    batch N."""
                    t_read = time.time()
                    datas = list(pool.map(read_tile, tile_batch))
                    ok_idx = [i for i, d in enumerate(datas)
                              if d is not None]
                    arr = np.zeros((batch, h, w, 1), np.float32)
                    for k, i in enumerate(ok_idx):
                        arr[k] = datas[i]
                    t_put = time.time()
                    dev = engine.put_tiles(arr)
                    return ok_idx, dev, t_put - t_read, time.time() - t_put

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
                pending: deque = deque()  # (batch tiles, device outputs)
                while futures:
                    tile_batch, fut = futures.popleft()
                    ok_idx, dev, read_s, put_s = fut.result()
                    submit_read()
                    self.report.read_s += read_s
                    self.report.h2d_put_s += put_s
                    ok_set = set(ok_idx)
                    for i, t in enumerate(tile_batch):
                        if i not in ok_set:
                            self.report.tile_errors.append(
                                (t.tid, "read failed"))
                            logger.error("Failed to read tile %d, skipping",
                                         t.tid)
                    outs = engine.process_async(dev)
                    pending.append(([tile_batch[i] for i in ok_idx], outs))
                    self.report.max_inflight_batches = max(
                        self.report.max_inflight_batches,
                        len(futures) + len(pending))
                    if len(pending) > 2:
                        drain(pending.popleft())
                while pending:
                    drain(pending.popleft())
        # canonical tileId order: the stitched catalog (S1..SN naming,
        # component traversal) is a pure function of the tile-result set
        results.sort(key=lambda tr: tr["tileId"])
        nb = neighbor_table(tiles)
        for tr in results:
            tr["neighborTileIds"] = nb[tr["tileId"]]
        return results

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
        return {"objs": objs, "tileId": t.tid, "workerId": 0,
                "neighborTileIds": [],
                "xmin": t.xmin, "xmax": t.xmax,
                "ymin": t.ymin, "ymax": t.ymax}

    # -- output --------------------------------------------------------------

    def save(self):
        """Write the mosaic catalog and DS9 regions (reference
        inference.py:641-648, 1167-1287)."""
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
