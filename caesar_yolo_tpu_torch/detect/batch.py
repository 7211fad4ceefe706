"""Shape-bucketed, batch-padded, prefetching multi-image detection.

Counterpart of caesar_yolo_tpu/detect/batch.py.  Dataset workloads
(datalist detection, quality evaluation over thousands of 132 px cutouts;
reference macros/make_prediction.py:645-658) would call the model once
per image; this runner groups images by shape, pads each group with zero
images into fixed batches, and drives them through one TileEngine: the
image loads run ahead on a thread pool, the host-to-device copy of a
batch runs in a worker thread (pinned and non-blocking, on the current
stream) while the previous batch's compute is enqueued, each batch's
results start their copy to the host as it is enqueued, and they are
drained one batch behind dispatch.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from caesar_yolo_tpu_torch import logger


class BatchedDetector:
    """Batched detection over many images through a shared TileEngine.

    detect_many(items, load_fn) -> {key: (boxes, scores, class_ids, ok)}
      items:   sequence of keys (paths, ids, ...)
      load_fn: key -> [H, W, C] float32 array (or None on read failure)

    Results are raw per-image NMS outputs in image coordinates with the
    padding stripped (None for an unreadable image); callers apply
    merge_detections and the output writers.  `model` carries its weights;
    `device` and `engine_kwargs` go to the TileEngine (CUDA by default).
    """

    def __init__(self, model, *, preprocessor=None, img_size: int = 640,
                 score_thr: float = 0.7, iou_thr: float = 0.5,
                 pre_nms: int = 512, batch_size: int = 32, device=None,
                 **engine_kwargs):
        # imported here as in the reference: parallel/ imports detect/*
        from caesar_yolo_tpu_torch.parallel.engine import TileEngine
        self.engine = TileEngine(
            model, preprocessor=preprocessor, img_size=img_size,
            score_thr=score_thr, iou_thr=iou_thr, pre_nms=pre_nms,
            device=device, **engine_kwargs)
        self.batch_size = max(int(batch_size), 1)
        self.pre_nms = pre_nms

    def detect_many(self, items, load_fn, *, read_workers: int = 8):
        results: dict = {}
        with ThreadPoolExecutor(max_workers=read_workers) as pool:
            buckets: dict[tuple, list] = {}  # shape -> [(key, img)]
            staged: deque = deque()          # [(keys, staging future)]
            pending: list = []               # [(keys, host fetch)]

            def launch(item):
                """Enqueue the compute of an already-staged batch."""
                keys, put_fut = item
                pending.append((keys, self.engine.to_host_async(
                    self.engine.process_async(put_fut.result()))))
                # drain one behind dispatch: bounds device-result memory
                # while host loads overlap device compute
                if len(pending) > 1:
                    self._drain(pending.pop(0), results)

            def dispatch(pairs, shape):
                h, w, c = shape
                arr = np.zeros((self.batch_size, h, w, c), np.float32)
                for i, (_, img) in enumerate(pairs):
                    arr[i] = img
                # the copy of THIS batch runs in a worker while the batch
                # staged before it is enqueued
                staged.append(([k for k, _ in pairs],
                               pool.submit(self.engine.put_tiles, arr)))
                if len(staged) > 1:
                    launch(staged.popleft())

            # bounded read-ahead: never more than ~2 batches of images
            keys_iter = iter(items)
            futs: deque = deque()

            def submit_next():
                try:
                    k = next(keys_iter)
                except StopIteration:
                    return False
                futs.append((k, pool.submit(load_fn, k)))
                return True

            for _ in range(2 * self.batch_size):
                if not submit_next():
                    break
            while futs:
                key, fut = futs.popleft()
                img = fut.result()
                submit_next()
                if img is None:
                    logger.warning("Skipping unreadable image %s", key)
                    results[key] = None
                    continue
                img = np.asarray(img, np.float32)
                if img.ndim == 2:
                    img = img[:, :, None]
                shape = img.shape
                buckets.setdefault(shape, []).append((key, img))
                if len(buckets[shape]) == self.batch_size:
                    dispatch(buckets.pop(shape), shape)
                # mixed-shape lists: flush the fullest partial bucket once
                # more than ~2 batches of images are resident
                elif sum(len(v) for v in buckets.values()) \
                        > 2 * self.batch_size:
                    big = max(buckets, key=lambda s: len(buckets[s]))
                    dispatch(buckets.pop(big), big)
            for shape, pairs in buckets.items():
                dispatch(pairs, shape)
            while staged:
                launch(staged.popleft())
            for p in pending:
                self._drain(p, results)
        return results

    def _drain(self, item, results):
        keys, fetch = item
        boxes, scores, cls, valid, ok, ndrop = fetch()
        for i, key in enumerate(keys):
            if ndrop[i]:
                logger.warning(
                    "Image %s: NMS pre-filter dropped %d above-threshold "
                    "candidates (raise pre_nms=%d)", key, int(ndrop[i]),
                    self.pre_nms)
            v = valid[i]
            results[key] = (boxes[i][v], scores[i][v], cls[i][v],
                            bool(ok[i]))
