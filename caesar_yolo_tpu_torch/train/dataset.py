"""YOLO-format detection dataset loading (host side).

Counterpart of caesar_yolo_tpu/train/dataset.py, of which it keeps its own
copy (the port never imports the JAX package): the ultralytics dataset
layout (a YAML root with image directories, one `labels/<stem>.txt` per
image with normalised `class cx cy w h` rows), fixed-shape batches (gt
boxes padded to max_gt with a mask), a shuffle that is a pure function of
(seed, epoch), and threaded prefetch one batch ahead.

FITS images go through the port's reader (utils/fits.py), min-maxed per
image; PNG/JPEG through its `read_image` (JPEG needs Pillow), divided by
255 where they are not already in [0, 1], as the reference package does.
"""

from __future__ import annotations

import os
import re
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from caesar_yolo_tpu_torch import logger
from caesar_yolo_tpu_torch.detect.letterbox import letterbox_geometry
from caesar_yolo_tpu_torch.utils.fits import read_fits, read_image

IMG_EXTS = (".png", ".jpg", ".jpeg", ".fits")


def _split_flow_list(inner: str) -> list[str]:
    """Split the inside of a YAML flow list `[...]` into items,
    respecting single/double quotes so names containing commas
    (`['a, b', c]`) stay one item.  Raises on an unterminated quote
    rather than silently mis-splitting (class-id/name alignment feeds
    every downstream catalog)."""
    items, buf, quote = [], [], None
    for ch in inner:
        if quote:
            if ch == quote:
                quote = None
            else:
                buf.append(ch)
        elif ch in "'\"":
            quote = ch
        elif ch == ",":
            items.append("".join(buf).strip())
            buf = []
        else:
            buf.append(ch)
    if quote:
        raise ValueError(f"unterminated quote in names list: [{inner}]")
    items.append("".join(buf).strip())
    return [v for v in items if v]


def parse_dataset_yaml(path: str) -> dict:
    """Minimal YAML subset parser for ultralytics dataset files: flat
    `key: value` pairs plus a `names:` block in any of the three
    spellings ultralytics accepts — `idx: name` mapping lines, `- name`
    list lines, or an inline flow list `names: [a, b, c]` (single- or
    multi-line, quote-aware)."""
    out: dict = {}
    names: dict = {}
    name_list: list = []
    in_names = False
    flow_buf: str | None = None  # accumulating a multi-line [...] list
    with open(path) as f:
        for line in f:
            if not line.strip() or line.strip().startswith("#"):
                continue
            if flow_buf is not None:
                flow_buf += " " + line.strip()
                if flow_buf.rstrip().endswith("]"):
                    name_list = _split_flow_list(
                        flow_buf.strip()[1:-1])
                    flow_buf = None
                continue
            m = re.match(r"^names\s*:\s*(.*)$", line)
            if m:
                inline = m.group(1).strip()
                if inline.startswith("[") and inline.endswith("]"):
                    name_list = _split_flow_list(inline[1:-1])
                    in_names = False
                elif inline.startswith("["):
                    flow_buf = inline
                    in_names = False
                else:
                    in_names = True
                continue
            if in_names:
                m = re.match(r"^\s+(\d+)\s*:\s*(.+)$", line)
                if m:
                    names[int(m.group(1))] = m.group(2).strip().strip("'\"")
                    continue
                m = re.match(r"^\s*-\s*(.+)$", line)
                if m:
                    name_list.append(m.group(1).strip().strip("'\""))
                    continue
                in_names = False
            m = re.match(r"^(\w+)\s*:\s*(.+)$", line)
            if m:
                out[m.group(1)] = m.group(2).strip().strip("'\"")
    if flow_buf is not None:
        raise ValueError(f"{path}: unterminated names flow list")
    if names:
        out["names"] = [names[i] for i in sorted(names)]
    elif name_list:
        out["names"] = name_list
    return out


def _label_path(img_path: str) -> str:
    base, _ = os.path.splitext(img_path)
    return (base.replace(f"{os.sep}images{os.sep}",
                         f"{os.sep}labels{os.sep}") + ".txt")


def list_images(directory: str) -> list[str]:
    out = []
    for root, _, files in os.walk(directory):
        for f in sorted(files):
            if os.path.splitext(f)[1].lower() in IMG_EXTS:
                out.append(os.path.join(root, f))
    return out


def letterbox_pixels(img: np.ndarray, img_size: int) -> np.ndarray:
    """Host-side letterbox of [H, W, C] f32 -> [S, S, C]: aspect-
    preserving bilinear resize + centered 114/255 pad (the geometry of
    detect/letterbox.letterbox_geometry, so boxes computed against it
    are valid for BOTH the host and device pixel paths)."""
    h, w = img.shape[:2]
    r, nh, nw, top, left = letterbox_geometry(h, w, img_size)
    out = np.full((img_size, img_size, img.shape[-1]), 114 / 255.0,
                  np.float32)
    if (nh, nw) != (h, w):
        yi = (np.arange(nh) + 0.5) / r - 0.5
        xi = (np.arange(nw) + 0.5) / r - 0.5
        yi = np.clip(yi, 0, h - 1)
        xi = np.clip(xi, 0, w - 1)
        y0 = np.floor(yi).astype(int)
        x0 = np.floor(xi).astype(int)
        y1 = np.minimum(y0 + 1, h - 1)
        x1 = np.minimum(x0 + 1, w - 1)
        fy = (yi - y0)[:, None, None]
        fx = (xi - x0)[None, :, None]
        resized = (img[y0][:, x0] * (1 - fy) * (1 - fx)
                   + img[y0][:, x1] * (1 - fy) * fx
                   + img[y1][:, x0] * fy * (1 - fx)
                   + img[y1][:, x1] * fy * fx)
    else:
        resized = img
    out[top:top + nh, left:left + nw] = resized
    return out


def load_sample(img_path: str, img_size: int, max_gt: int,
                native: bool = False):
    """-> (image f32 in [0, 1], labels [M], boxes [M, 4] xyxy px in the
    LETTERBOXED img_size frame, mask [M]) or None on read failure.

    native=False: the image is letterboxed to [S, S, C] on the host.
    native=True: the image stays at its native resolution and channel
    count, boxes still in the img_size letterbox frame; the consumer
    letterboxes on the device (detect/letterbox.letterbox_batch)."""
    ext = os.path.splitext(img_path)[1].lower()
    if ext == ".fits":
        res = read_fits(img_path)
        if res is None:
            return None
        img = np.asarray(res[0], np.float32)
        # FITS pixels are instrument units: min-max them to [0, 1] per
        # image
        lo, hi = float(img.min()), float(img.max())
        img = (img - lo) / (hi - lo) if hi > lo else np.zeros_like(img)
    else:
        res = read_image(img_path)
        if res is None:
            return None
        img = np.asarray(res[0], np.float32)
        if img.max() > 1.5:
            img = img / 255.0
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[-1] == 1 and not native:
        img = np.repeat(img, 3, axis=-1)
    h, w = img.shape[:2]
    r, nh, nw, top, left = letterbox_geometry(h, w, img_size)
    out = img if native else letterbox_pixels(img, img_size)

    labels = np.zeros((max_gt,), np.int32)
    boxes = np.zeros((max_gt, 4), np.float32)
    mask = np.zeros((max_gt,), bool)
    lpath = _label_path(img_path)
    if os.path.exists(lpath):
        rows = []
        with open(lpath) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 5:
                    rows.append([float(v) for v in parts[:5]])
        for i, (cid, cx, cy, bw, bh) in enumerate(rows[:max_gt]):
            x1 = (cx - bw / 2) * w * r + left
            y1 = (cy - bh / 2) * h * r + top
            x2 = (cx + bw / 2) * w * r + left
            y2 = (cy + bh / 2) * h * r + top
            labels[i] = int(cid)
            boxes[i] = [x1, y1, x2, y2]
            mask[i] = True
        if len(rows) > max_gt:
            logger.warning("%s: %d gt boxes truncated to max_gt=%d",
                           img_path, len(rows), max_gt)
    return out, labels, boxes, mask


class DetectionDataset:
    """Iterable of fixed-shape train batches (numpy) with threaded
    prefetch."""

    def __init__(self, image_dir_or_yaml: str, *, img_size: int = 640,
                 batch_size: int = 16, max_gt: int = 64, split: str = "train",
                 shuffle: bool = True, seed: int = 0, workers: int = 8,
                 device_letterbox: bool = False):
        if image_dir_or_yaml.endswith((".yaml", ".yml")):
            spec = parse_dataset_yaml(image_dir_or_yaml)
            root = spec.get("path", os.path.dirname(image_dir_or_yaml))
            rel = spec.get(split, split)
            directory = rel if os.path.isabs(rel) else os.path.join(root, rel)
            self.class_names = spec.get("names")
        else:
            directory = image_dir_or_yaml
            self.class_names = None
        self.paths = list_images(directory)
        if not self.paths:
            raise FileNotFoundError(f"no images under {directory}")
        self.img_size = img_size
        self.batch_size = batch_size
        self.max_gt = max_gt
        self.shuffle = shuffle
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.workers = workers
        # native-resolution batches (boxes in the letterbox frame) for a
        # consumer that letterboxes on the device; batches of mixed native
        # shapes are letterboxed on the host after all
        self.device_letterbox = device_letterbox

    def set_epoch(self, epoch: int):
        """Reseed the shuffle as a pure function of (seed, epoch), so that
        a resumed run at epoch N sees the order an uninterrupted run saw."""
        self.rng = np.random.default_rng([self.seed, int(epoch)])

    def __len__(self):
        return len(self.paths) // self.batch_size

    def __iter__(self):
        order = np.arange(len(self.paths))
        if self.shuffle:
            self.rng.shuffle(order)
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order) - self.batch_size + 1,
                                  self.batch_size)]
        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            # one batch ahead: batch i+1 decodes while the consumer's
            # device step runs on batch i
            futs: deque = deque()
            pos = 0

            def submit():
                nonlocal pos
                if pos < len(batches):
                    futs.append([
                        pool.submit(load_sample, self.paths[j],
                                    self.img_size, self.max_gt,
                                    self.device_letterbox)
                        for j in batches[pos]])
                    pos += 1

            submit()
            submit()
            while futs:
                samples = [f.result() for f in futs.popleft()]
                submit()
                samples = [s for s in samples if s is not None]
                if not samples:
                    continue
                while len(samples) < self.batch_size:
                    samples.append(samples[0])  # pad a short batch
                if self.device_letterbox and len(
                        {s[0].shape for s in samples}) > 1:
                    samples = [(letterbox_pixels(
                        np.repeat(s[0], 3, -1) if s[0].shape[-1] == 1
                        else s[0], self.img_size),) + s[1:]
                        for s in samples]
                imgs, labels, boxes, masks = (np.stack(x) for x in
                                              zip(*samples))
                yield imgs, labels, boxes, masks
