"""Weights: ultralytics `.pt` checkpoints and the reference's npz format.

Counterpart of caesar_yolo_tpu/models/convert.py.

The reference's users hold ultralytics `.pt` checkpoints (reference
scripts/run.py:347 loads them into ultralytics; README.md:190-207 lists
the published ones).  `load_torch_state_dict` reads one without the
ultralytics package: the pickle names ultralytics classes, and a "ghost
module" unpickler makes each class that is missing at load time a bare
nn.Module subclass, enough to walk `state_dict()`.  `convert_state_dict`
maps its keys onto the port's module tree, which keeps torch's OIHW
layout, so no transpose is needed.  The mapping relies on these layout
facts of the published architectures:
  - `model.model` is a flat Sequential whose indices are the yaml rows,
    the order in which models/yolo.py builds its layers;
  - the Detect head's cv2 is the box branch (Conv, Conv, Conv2d) and cv3
    the class branch (v8: Conv, Conv, Conv2d; v11 and v12: (DWConv, Conv)
    twice, then Conv2d); dfl.conv.weight is the fixed arange kernel,
    dropped (decode takes the expectation itself);
  - a YOLO12 A2C2f keeps cv1, cv2, its layer scale `gamma` (scales l and
    x) and in `m.<j>` either a Sequential of two ABlocks (`m.<j>.<i>.attn.
    {qkv,proj,pe}`, `m.<j>.<i>.mlp.{0,1}`) or a C3k laid out as C3.

The reference's npz: its params pytree flattened to '/'-joined keys plus
a `__meta__` JSON entry (caesar_yolo_tpu/models/convert.py:save_params).
The port's module tree carries the same names, so carrying weights across
is a mechanical walk: '/' becomes '.', and conv kernels turn from HWIO to
OIHW.

Inference takes a shorter route from an npz (cli.run): `read_npz` reads
every member's bytes once, straight into one host buffer (pinned for a
GPU), checking each CRC-32 as np.load does; `build_prepared` builds the
module tree on the meta device (no init that the weights overwrite),
copies the buffer to the device in one piece, and there folds BatchNorm
(every conv's statistics at once), lays the kernels out OIHW and casts
them: the model predictor.prepare_model makes from `load_model`'s, bit for
bit, without the f32 model on the CPU or its copy.
"""

from __future__ import annotations

import io
import json
import math
import os
import pickle
import re
import struct
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from caesar_yolo_tpu_torch import logger
from caesar_yolo_tpu_torch.models.layers import (
    A2C2f,
    BatchNorm,
    C2PSA,
    C2f,
    C3,
    C3k2,
    Concat,
    Conv,
    SPPF,
    Upsample,
    bn_scale_shift,
    fold_bn_weight,
)
from caesar_yolo_tpu_torch.models.yolo import YOLO, build_model
from caesar_yolo_tpu_torch.utils.trace import NULL


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _unflatten(flat: dict):
    root: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def load_params(path: str):
    """Load (params pytree of numpy arrays, meta) from a reference npz."""
    with np.load(path) as data:
        flat, meta = {}, {}
        for k in data.files:
            if k == "__meta__":
                meta = json.loads(bytes(data[k].tobytes()).decode())
            else:
                flat[k] = data[k]
    return _unflatten(flat), meta


def state_from_params(params) -> dict[str, torch.Tensor]:
    """The reference's params pytree (numpy arrays) -> the port's
    state_dict: '/' -> '.', 4-D conv kernels HWIO -> OIHW; float leaves in
    f32, the int8 weights of a quantized tree (models/quant.py) in int8."""
    state = {}
    for key, value in _flatten(params):
        arr = np.asarray(value)
        arr = arr if arr.dtype == np.int8 else arr.astype(np.float32)
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        state[key.replace("/", ".")] = torch.from_numpy(arr.copy())
    return state


def params_from_state(state: dict) -> dict:
    """The inverse of `state_from_params`: the port's state_dict -> the
    reference's params pytree of numpy f32 arrays, int8 weights kept int8
    ('.' -> '/', 4-D conv kernels OIHW -> HWIO)."""
    flat = {}
    for key, value in state.items():
        value = value.detach().cpu()
        arr = (value if value.dtype == torch.int8 else value.float()).numpy()
        if arr.ndim == 4:
            arr = arr.transpose(2, 3, 1, 0)
        # a copy: .numpy() of a CPU tensor shares its memory
        flat[key.replace(".", "/")] = np.array(arr, order="C")
    return _unflatten(flat)


def flat_params(state: dict) -> dict[str, np.ndarray]:
    """The port's state_dict (or a dict of the same keys, such as the
    trainer's EMA) -> {the reference's param path ('head/box/0/2/w',
    '.../bn/gamma'): f32 array in the reference's layout}, for comparing
    parameter trees leaf by leaf."""
    return dict(_flatten(params_from_state(state)))


def save_params(model: YOLO, path: str, meta: dict | None = None) -> str:
    """Save `model`'s weights in the reference's npz format (flat
    '/'-joined keys plus a `__meta__` JSON entry), which
    caesar_yolo_tpu/models/convert.py:load_params reads.  Returns the
    path written (".npz" appended when absent, as np.savez does)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    flat = flat_params(model.state_dict())
    flat["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8)
    np.savez(path, **flat)
    return path


def load_jax_params(model: YOLO, params) -> YOLO:
    """Carry the reference's params pytree into `model` (strict: every
    key on both sides must match).  A fused tree (no BatchNorm leaves, as
    the reference's fuse_model_params writes) fuses `model` first; a
    quantized one (the reference's quantize_model: fused, {wq, ws, xs, b}
    on the int8 convs) also gives it its int8 layers (quant.int8_layout)."""
    state = state_from_params(params)
    if not any(".bn." in k for k in state):
        from caesar_yolo_tpu_torch.models.quant import int8_layout
        int8_layout(model, state)
    model.load_state_dict(state, strict=True)
    return model


def load_model(path: str) -> tuple[YOLO, dict]:
    """Build the model named in a reference npz's meta and load its
    weights -> (model on the CPU in f32, meta)."""
    params, meta = load_params(path)
    model = build_model(meta["model"],
                        num_classes=int(meta.get("num_classes", 5)))
    return load_jax_params(model, params), meta


# ---------------------------------------------------------------------------
# The inference model straight from an npz
# ---------------------------------------------------------------------------

_BN_STATS = ("gamma", "beta", "mean", "var")
_LOCAL_HEADER = struct.Struct("<4s2B4HL2L2H")   # zipfile's structFileHeader
_F32 = np.dtype("<f4")
# members of 64 KiB and more (99% of a yolo11l npz's bytes) are read on 4
# threads: on the 8 cores of an H100 host 8 threads read its 100 MB slower
# than 4 (0.11-0.30 s against 0.03-0.04 s)
_POOLED_BYTES = 1 << 16
_READERS = 4


@dataclass
class _Member:
    key: str          # the npz key ('/'-joined, without ".npy")
    start: int        # file offset of the member's bytes (the .npy file)
    size: int
    crc: int
    data: int         # offset of the array data inside the member
    shape: tuple
    fortran: bool     # stored in column-major order
    dst: int = 0      # offset in the host buffer (f32 elements)


@dataclass
class NpzWeights:
    """An npz's f32 leaves in one host buffer (`read_npz`).  `leaves` maps
    each '/'-joined key to (offset in `buffer`, shape as stored: conv
    kernels HWIO, whether column-major: np.save keeps the order of an
    array that is Fortran-contiguous, as a 1x1 kernel's OIHW -> HWIO
    transpose is).  The conv kernels come first, each at a 64-byte
    boundary; then `bn`, the BatchNorm statistics as four rows [gamma;
    beta; mean; var] with one column block per conv; then `rest`, every
    other leaf."""
    buffer: torch.Tensor      # f32 [n]
    leaves: dict
    bn: slice
    rest: slice
    meta: dict

    def leaf(self, t: torch.Tensor, key: str, base: int = 0):
        """Leaf `key` as a view of `t`, a copy of the buffer from element
        `base` on."""
        off, shape, fortran = self.leaves[key]
        off -= base
        t = t[off:off + math.prod(shape)]
        if not fortran:
            return t.view(shape)
        return t.view(shape[::-1]).permute(*range(len(shape) - 1, -1, -1))


def _npz_members(fd: int, infos) -> list[_Member] | None:
    """Where each member's array lies in the file, from its zip local
    header and .npy header; None unless every member is a stored .npy of
    little-endian f32 (but `__meta__`, bytes)."""
    members, headers = [], {}
    for info in infos:
        if (info.compress_type != zipfile.ZIP_STORED or info.flag_bits & 1
                or not info.filename.endswith(".npy")):
            return None
        # the local header (its name and extra field lengths at 10, 11),
        # then the .npy magic, version and header length
        head = os.pread(fd, 1024, info.header_offset)
        fields = _LOCAL_HEADER.unpack_from(head)
        if fields[0] != b"PK\x03\x04":
            raise zipfile.BadZipFile(
                f"bad local header of {info.filename!r}")
        at = _LOCAL_HEADER.size + fields[10] + fields[11]
        start = info.header_offset + at
        npy = head[at:at + 12]
        if npy[:6] != b"\x93NUMPY" or npy[6] not in (1, 2):
            return None
        n = (10 + struct.unpack_from("<H", npy, 8)[0] if npy[6] == 1
             else 12 + struct.unpack_from("<I", npy, 8)[0])
        header = (head[at:at + n] if at + n <= len(head)
                  else os.pread(fd, n, start))
        if header not in headers:
            f = io.BytesIO(header)
            version = np.lib.format.read_magic(f)
            headers[header] = (np.lib.format.read_array_header_1_0(f)
                               if version == (1, 0) else
                               np.lib.format.read_array_header_2_0(f))
        shape, fortran, dtype = headers[header]
        key = info.filename[:-4]
        ok = (dtype == np.uint8 and len(shape) == 1 if key == "__meta__"
              else dtype == _F32)
        if not ok or n + math.prod(shape) * dtype.itemsize != \
                info.file_size:
            return None
        members.append(_Member(key, start, info.file_size, info.CRC, n,
                               tuple(shape), fortran))
    return members


def _layout(members: list[_Member]):
    """Give each member its offset in the host buffer -> (elements, bn
    rows, rest) as NpzWeights lays them out."""
    end = 0

    def place(n: int, align: int = 1) -> int:
        nonlocal end
        at = -(-end // align) * align
        end = at + n
        return at

    by_key = {m.key: m for m in members}
    kernels = [m for m in members if len(m.shape) == 4]
    quads = []
    for m in members:
        if m.key.endswith("/bn/gamma"):
            quad = [by_key.get(m.key[:-5] + s) for s in _BN_STATS]
            if all(q is not None and q.shape == m.shape and len(q.shape) == 1
                   for q in quad):
                quads.append(quad)
    in_bn = {id(q) for quad in quads for q in quad}
    for m in kernels:
        m.dst = place(math.prod(m.shape), 16)
    cols = sum(quad[0].shape[0] for quad in quads)
    bn0 = place(4 * cols, 16)
    col = 0
    for quad in quads:
        for row, m in enumerate(quad):
            m.dst = bn0 + row * cols + col
        col += quad[0].shape[0]
    rest0 = place(0, 16)
    for m in members:
        if len(m.shape) != 4 and id(m) not in in_bn:
            m.dst = place(math.prod(m.shape))
    return end, slice(bn0, bn0 + 4 * cols), slice(rest0, end)


def _read_member(fd: int, m: _Member, buf: np.ndarray) -> None:
    """Read member `m`'s array into its place in `buf` (f32) and check the
    member's CRC-32 (its .npy header and data, as zipfile does)."""
    nbytes = m.size - m.data
    dst = memoryview(buf.view(np.uint8)[4 * m.dst:4 * m.dst + nbytes])
    done = 0
    while done < nbytes:        # a read may return short
        n = os.preadv(fd, [dst[done:]], m.start + m.data + done)
        if n == 0:
            raise zipfile.BadZipFile(f"truncated member {m.key!r}")
        done += n
    if zlib.crc32(dst, zlib.crc32(os.pread(fd, m.data, m.start))) != m.crc:
        raise zipfile.BadZipFile(f"Bad CRC-32 for file {m.key!r}.npy")


def read_npz(path: str, *, pin: bool = False,
             recorder=NULL) -> NpzWeights | None:
    """Read a reference npz's leaves into one f32 host buffer, pinned with
    `pin` (for one copy to a GPU) -> NpzWeights, or None where the file
    takes `load_params`' route: a member compressed or holding anything
    but little-endian f32, or no BatchNorm leaves (a fused or int8
    quantized tree).  Each member's bytes are read once, on a pool of
    threads, straight into their place, and its CRC-32 checked: a corrupt
    member raises zipfile.BadZipFile, as np.load does.  The read and the
    checks are the span `weights.read`."""
    with open(path, "rb", buffering=0) as f:
        fd = f.fileno()
        with zipfile.ZipFile(f) as z:
            members = _npz_members(fd, z.infolist())
        if members is None:
            return None
        meta = next((m for m in members if m.key == "__meta__"), None)
        members = [m for m in members if m is not meta]
        n, bn, rest = _layout(members)
        if bn.stop == bn.start:
            return None
        buffer = torch.empty(n, dtype=torch.float32, pin_memory=pin)
        dst = buffer.numpy()
        readers = min(_READERS, os.cpu_count() or 1)
        with recorder.span("weights.read"), \
                ThreadPoolExecutor(readers) as pool:
            # the large members on the pool (their reads and checks leave
            # the interpreter lock), the small ones here
            pooled = [pool.submit(_read_member, fd, m, dst)
                      for m in members if m.size >= _POOLED_BYTES]
            for m in members:
                if m.size < _POOLED_BYTES:
                    _read_member(fd, m, dst)
            for done in pooled:
                done.result()
            if meta is not None:
                text = os.pread(fd, meta.size, meta.start)
                if zlib.crc32(text) != meta.crc:
                    raise zipfile.BadZipFile(
                        "Bad CRC-32 for file '__meta__.npy'")
                meta = json.loads(text[meta.data:].decode())
    return NpzWeights(buffer, {m.key: (m.dst, m.shape, m.fortran)
                               for m in members}, bn, rest, meta or {})


def _oihw(shape: tuple) -> tuple:
    return (shape[3], shape[2], shape[0], shape[1]) if len(shape) == 4 \
        else shape


@torch.no_grad()
def build_prepared(weights: NpzWeights, name: str, num_classes: int, *,
                   dtype: torch.dtype, device: torch.device,
                   recorder=NULL) -> YOLO:
    """The inference model of `weights` on `device`, as
    predictor.prepare_model(load_jax_params(build_model(name,
    num_classes), params), dtype=dtype, device=device) makes
    it, bit for bit (names, dtypes, shapes, strides): BatchNorm folded in
    f32, conv kernels in `dtype` (channels_last on CUDA), biases and
    layer scales in f32.  The module tree is built on the meta device;
    keys and shapes must match its own, as load_jax_params' strict load.
    BatchNorm's scale and shift are computed on the host conv by conv, as
    prepare_model computes them (the card's square root rounds otherwise),
    into the buffer's gamma and beta rows: `weights` is spent.
    The buffer goes to the device in one copy (span `weights.upload`,
    non-blocking from pinned memory); the kernels' products with the
    scale, their HWIO -> OIHW layout and the casts run there (the fold,
    span `weights.fold`, on both sides of the copy).  Each kernel is a
    tensor of its own; biases and layer scales are views of two small
    blocks."""
    with torch.device("meta"):
        model = build_model(name, num_classes=num_classes)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k.replace("/", "."): _oihw(leaf[1])
           for k, leaf in weights.leaves.items()}
    if got != want:
        odd = sorted(k for k in got.keys() & want.keys() if got[k] != want[k])
        raise RuntimeError(
            f"weights do not fit {name}: missing "
            f"{sorted(want.keys() - got.keys())[:5]}, unexpected "
            f"{sorted(got.keys() - want.keys())[:5]}, other shapes at "
            f"{odd[:5]}")
    with recorder.span("weights.fold"):
        # conv by conv, as prepare_model: over all convs at once the
        # host's intra-op threads split the vector, and a split once
        # rounded otherwise (the direct route's bit-equality test on the
        # CPU failed about one run in twenty)
        rows = weights.buffer[weights.bn].view(4, -1)
        for key, (off, shape, _) in weights.leaves.items():
            if key.endswith("/bn/gamma"):
                col = off - weights.bn.start
                block = rows[:, col:col + shape[0]]
                block[:2] = torch.stack(bn_scale_shift(*block))
    with recorder.span("weights.upload"):
        dev = weights.buffer.to(device, non_blocking=True)
    with recorder.span("weights.fold"):
        fmt = (torch.channels_last if device.type == "cuda"
               else torch.contiguous_format)

        def kernel(key):     # stored HWIO
            return weights.leaf(dev, key).permute(3, 2, 0, 1)

        scale, shift = dev[weights.bn].view(4, -1)[:2].clone()
        rest = dev[weights.rest].clone()
        for mod_name, module in list(model.named_modules()):
            prefix = mod_name.replace(".", "/") + "/" if mod_name else ""
            if isinstance(module, Conv):
                off, (c,), _ = weights.leaves[prefix + "bn/gamma"]
                cols = slice(off - weights.bn.start, off - weights.bn.start
                             + c)
                w = fold_bn_weight(kernel(prefix + "w"), scale[cols])
                module.set_fused(w.to(dtype, memory_format=fmt, copy=True),
                                 shift[cols])
            elif not isinstance(module, BatchNorm):
                for attr in list(module._parameters):
                    key = prefix + attr
                    module._parameters[attr] = nn.Parameter(
                        kernel(key).to(dtype, memory_format=fmt, copy=True)
                        if len(weights.leaves[key][1]) == 4 else
                        weights.leaf(rest, key, weights.rest.start))
    model.eval()
    model.compute_dtype = dtype
    return model


# ---------------------------------------------------------------------------
# Ultralytics .pt checkpoints, without ultralytics
# ---------------------------------------------------------------------------

class _GhostUnpickler(pickle.Unpickler):
    """Resolves each class the pickle names but this process cannot import
    to a fabricated bare nn.Module subclass of that name."""

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return type(name, (torch.nn.Module,), {"__module__": module})


class _GhostPickleModule:
    """The `pickle_module` torch.load takes: its Unpickler is the ghost
    one."""
    Unpickler = _GhostUnpickler

    @staticmethod
    def load(f, **kw):
        return _GhostUnpickler(f).load()


def load_torch_state_dict(pt_path: str) -> dict[str, np.ndarray]:
    """{key: float32 array} of an ultralytics .pt checkpoint: its `ema`
    model where present, else its `model`, else the file's own plain
    state_dict."""
    ckpt = torch.load(pt_path, map_location="cpu", weights_only=False,
                      pickle_module=_GhostPickleModule)
    if isinstance(ckpt, dict):
        model = ckpt.get("ema") or ckpt.get("model") or ckpt
    else:
        model = ckpt
    if hasattr(model, "state_dict"):
        sd = model.state_dict()
    elif isinstance(model, dict):
        sd = model  # already a flat state_dict
    else:
        raise ValueError(f"cannot find a model/state_dict in {pt_path}")
    return {k: v.detach().to(torch.float32).cpu().numpy()
            for k, v in sd.items() if hasattr(v, "detach")}


class _Mapper:
    """Takes ultralytics keys into the port's nested (OIHW) tree, keeping
    the keys it used."""

    def __init__(self, sd: dict[str, np.ndarray]):
        self.sd = sd
        self.used: set[str] = set()

    def take(self, key: str) -> np.ndarray:
        if key not in self.sd:
            raise KeyError(f"missing checkpoint key: {key}")
        self.used.add(key)
        return self.sd[key]

    def conv_block(self, p: str) -> dict:
        return {"w": self.take(f"{p}.conv.weight"),
                "bn": {"gamma": self.take(f"{p}.bn.weight"),
                       "beta": self.take(f"{p}.bn.bias"),
                       "mean": self.take(f"{p}.bn.running_mean"),
                       "var": self.take(f"{p}.bn.running_var")}}

    def conv_raw(self, p: str) -> dict:
        return {"w": self.take(f"{p}.weight"), "b": self.take(f"{p}.bias")}

    def bottleneck(self, p: str) -> dict:
        return {"cv1": self.conv_block(f"{p}.cv1"),
                "cv2": self.conv_block(f"{p}.cv2")}

    def c2f(self, module: C2f, p: str) -> dict:
        return {"cv1": self.conv_block(f"{p}.cv1"),
                "cv2": self.conv_block(f"{p}.cv2"),
                "m": [self.bottleneck(f"{p}.m.{j}")
                      for j in range(len(module.m))]}

    def c3(self, module: C3, p: str) -> dict:
        return {"cv1": self.conv_block(f"{p}.cv1"),
                "cv2": self.conv_block(f"{p}.cv2"),
                "cv3": self.conv_block(f"{p}.cv3"),
                "m": [self.bottleneck(f"{p}.m.{j}")
                      for j in range(len(module.m))]}

    def c3k2(self, module: C3k2, p: str) -> dict:
        return {"cv1": self.conv_block(f"{p}.cv1"),
                "cv2": self.conv_block(f"{p}.cv2"),
                "m": [self.c3(sub, f"{p}.m.{j}") if isinstance(sub, C3)
                      else self.bottleneck(f"{p}.m.{j}")
                      for j, sub in enumerate(module.m)]}

    def sppf(self, p: str) -> dict:
        return {"cv1": self.conv_block(f"{p}.cv1"),
                "cv2": self.conv_block(f"{p}.cv2")}

    def psablock(self, p: str) -> dict:
        return {"attn": {"qkv": self.conv_block(f"{p}.attn.qkv"),
                         "proj": self.conv_block(f"{p}.attn.proj"),
                         "pe": self.conv_block(f"{p}.attn.pe")},
                "ffn1": self.conv_block(f"{p}.ffn.0"),
                "ffn2": self.conv_block(f"{p}.ffn.1")}

    def c2psa(self, module: C2PSA, p: str) -> dict:
        return {"cv1": self.conv_block(f"{p}.cv1"),
                "cv2": self.conv_block(f"{p}.cv2"),
                "m": [self.psablock(f"{p}.m.{j}")
                      for j in range(len(module.m))]}

    def ablock(self, p: str) -> dict:
        return {"attn": {"qkv": self.conv_block(f"{p}.attn.qkv"),
                         "proj": self.conv_block(f"{p}.attn.proj"),
                         "pe": self.conv_block(f"{p}.attn.pe")},
                "mlp": [self.conv_block(f"{p}.mlp.0"),
                        self.conv_block(f"{p}.mlp.1")]}

    def a2c2f(self, module: A2C2f, p: str) -> dict:
        out = {"cv1": self.conv_block(f"{p}.cv1"),
               "cv2": self.conv_block(f"{p}.cv2"),
               "m": [self.c3(sub, f"{p}.m.{j}") if isinstance(sub, C3)
                     else [self.ablock(f"{p}.m.{j}.{i}")
                           for i in range(len(sub))]
                     for j, sub in enumerate(module.m)]}
        if module.gamma is not None:
            out["gamma"] = self.take(f"{p}.gamma")
        return out

    def detect_head(self, head, p: str) -> dict:
        """v8's class branch is cv3.L.{0,1,2}; v11's (DWConv, Conv) pairs
        are cv3.L.0.{0,1} and cv3.L.1.{0,1}, then cv3.L.2."""
        out = {"box": [], "cls": []}
        for lvl, cls_branch in enumerate(head.cls):
            out["box"].append([self.conv_block(f"{p}.cv2.{lvl}.0"),
                               self.conv_block(f"{p}.cv2.{lvl}.1"),
                               self.conv_raw(f"{p}.cv2.{lvl}.2")])
            if len(cls_branch) == 3:
                cls = [self.conv_block(f"{p}.cv3.{lvl}.0"),
                       self.conv_block(f"{p}.cv3.{lvl}.1")]
            else:
                cls = [self.conv_block(f"{p}.cv3.{lvl}.{a}.{b}")
                       for a in (0, 1) for b in (0, 1)]
            out["cls"].append(cls + [self.conv_raw(f"{p}.cv3.{lvl}.2")])
        return out


def convert_state_dict(sd: dict[str, np.ndarray],
                       model: YOLO) -> dict[str, torch.Tensor]:
    """A flat ultralytics state_dict -> `model`'s state_dict (f32, OIHW).
    Raises KeyError on a missing key; logs a warning on unused keys
    (num_batches_tracked and the DFL kernel are expected to be left)."""
    m = _Mapper(sd)
    tree = {}
    for i, (name, _) in enumerate(model.graph):
        mod = getattr(model, name)
        p = f"model.{i}"
        if isinstance(mod, Conv):
            tree[name] = m.conv_block(p)
        elif isinstance(mod, C3k2):
            tree[name] = m.c3k2(mod, p)
        elif isinstance(mod, C2f):
            tree[name] = m.c2f(mod, p)
        elif isinstance(mod, SPPF):
            tree[name] = m.sppf(p)
        elif isinstance(mod, C2PSA):
            tree[name] = m.c2psa(mod, p)
        elif isinstance(mod, A2C2f):
            tree[name] = m.a2c2f(mod, p)
        elif not isinstance(mod, (Upsample, Concat)):
            raise TypeError(f"unmapped module type {type(mod)} at layer {i}")
    tree["head"] = m.detect_head(model.head, f"model.{len(model.graph)}")
    unused = [k for k in sd if k not in m.used
              and not k.endswith("num_batches_tracked") and ".dfl." not in k]
    if unused:
        logger.warning("Converter: %d unused checkpoint keys (first: %s)",
                       len(unused), unused[:5])
    return {key.replace("/", "."): torch.from_numpy(
                np.array(value, dtype=np.float32))
            for key, value in _flatten(tree)}


def infer_num_classes(sd: dict, default: int = 5) -> int:
    """The class count: the length of the first class branch's final conv
    bias (the one head shape that holds it), else `default`."""
    nc_keys = [k for k in sd if ".cv3." in k and k.endswith("2.bias")]
    return int(sd[sorted(nc_keys)[0]].shape[0]) if nc_keys else default


def _infer_model_name(stem: str) -> str:
    """The stem itself if it is an architecture name, else the first
    `yolov8<s>` / `yolo11<s>` / `yolo12<s>` token inside it, else the stem
    unchanged
    (build_model then raises).  A fullmatch, not a prefix test: 'yolo11best'
    starts like a name but is not one, so the token search still applies
    to it."""
    if re.fullmatch(r"yolo(?:v8|v11|11|12)[nsmlx]?", stem):
        return stem
    found = re.search(r"yolo(?:v8|v11|11|12)[nsmlx]", stem)
    return found.group(0) if found else stem


def convert_checkpoint(pt_path: str, out_path: str | None = None,
                       model_name: str | None = None,
                       num_classes: int | None = None):
    """An ultralytics .pt -> (the port's model with its weights, on the
    CPU in f32; meta {"model", "num_classes"}), also saved in the
    reference's npz format when `out_path` is given.  The architecture
    defaults to the one named in the file's stem (`_infer_model_name`), the
    class count to the head's (`infer_num_classes`)."""
    name = model_name or _infer_model_name(
        os.path.splitext(os.path.basename(pt_path))[0])
    sd = load_torch_state_dict(pt_path)
    if num_classes is None:
        num_classes = infer_num_classes(sd)
    model = build_model(name, num_classes=num_classes)
    model.load_state_dict(convert_state_dict(sd, model), strict=True)
    meta = {"model": name, "num_classes": num_classes}
    if out_path:
        written = save_params(model, out_path, meta=meta)
        logger.info("Saved converted weights to %s", written)
    return model, meta
