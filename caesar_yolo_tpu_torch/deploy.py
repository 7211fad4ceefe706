"""Serving export: the detection step as one torch.export artifact.

Counterpart of caesar_yolo_tpu/deploy.py.  The whole tile step
(preprocess -> letterbox -> YOLO forward -> DFL decode -> fixed-shape NMS
-> unletterbox, parallel/engine.make_tile_step) is traced by torch.export
with the prepared weights (BN folded, cast, channels_last and int8-packed
on CUDA) held in the artifact, and saved to one blob.  A serving process
loads the blob and calls it: no `models/yolo.py`, no `ops/transforms.py`,
no weight files.

    blob = export_detector(model, preprocessor=pipe,
                           tile_shape=(640, 640, 1), batch=32)
    Path("detector.cyx").write_bytes(blob)
    # ... in the serving process:
    det = load_detector(Path("detector.cyx").read_bytes())
    boxes, scores, cls_ids, valid, tile_ok, n_dropped = det(tiles)

The kernels stay in the artifact: under export each wrapper calls its op
caesar_yolo::<name> (utils/portable.py), and `register_ops` imports the
wrapper modules that register them (and nothing of the model code), so
the loaded graph runs the hand-written kernels on the card and their
plain versions on the CPU, with the launch counters of the live path.
The live path does not go through the ops: a call through an op costs the
host about 19.5 us more than a direct launch (41.82 against 22.35 us on
an H100, PERF.md section 6), and a yolo11l
forward makes about 190 kernel calls.

Differences from the JAX package (ROADMAP.md, design differences):
  - one device per artifact: `platforms` is "cuda" (the default) or
    "cpu", and the artifact holds that device's weights; torch.export
    lowers for one device at a time, where jax.export takes several;
  - fixed shapes, as the JAX package's: one artifact per (batch,
    tile_shape);
  - the artifact holds the graph, not `torch.backends` switches: those
    read at run time (cuDNN's TF32 switch, which layers.conv_f32 turns on
    around its bf16 convs) are the serving process's.
"""

from __future__ import annotations

import importlib
import io
import json
import zipfile

import torch
from torch import nn

from caesar_yolo_tpu_torch.detect.nms import DEFAULT_PRE_NMS

FORMAT_VERSION = 1
META_FILE = "caesar_yolo.json"
PLATFORMS = ("cuda", "cpu")

# the wrapper modules that register the ops, and the ops: K1, K2, K3, K4,
# K5, K6, K7, K9 and K10, the forward kernels a tile step can reach
OP_MODULES = (
    "caesar_yolo_tpu_torch.detect.cuda_nms",
    "caesar_yolo_tpu_torch.models.cuda_attn",
    "caesar_yolo_tpu_torch.models.cuda_epilogue",
    "caesar_yolo_tpu_torch.models.cuda_qconv",
    "caesar_yolo_tpu_torch.ops.cuda_clahe",
    "caesar_yolo_tpu_torch.ops.cuda_histeq",
    "caesar_yolo_tpu_torch.ops.cuda_preproc",
    "caesar_yolo_tpu_torch.ops.cuda_stats",
    "caesar_yolo_tpu_torch.ops.cuda_upsample",
)
KERNEL_OPS = ("nms_suppress", "attention", "zscale_minmax", "upsample2x",
              "clip_stats", "equalize_hist", "equalize_adapthist", "qconv",
              "conv_epilogue")


def register_ops() -> None:
    """Register the nine ops caesar_yolo::<KERNEL_OPS> by importing their
    wrapper modules (which import no model code)."""
    for name in OP_MODULES:
        importlib.import_module(name)


class ServingStep(nn.Module):
    """The engine's tile step over a prepared model: forward(tiles[B, H, W,
    C]) -> (boxes[B, max_det, 4] in tile coords, scores, cls int32, valid,
    tile_ok[B], n_dropped[B] int32)."""

    def __init__(self, model: nn.Module, step):
        super().__init__()
        self.model = model
        self._step = step

    def forward(self, tiles: torch.Tensor):
        return self._step(tiles)


def build_serving_step(model, *, preprocessor=None, img_size: int = 640,
                       score_thr: float = 0.25, iou_thr: float = 0.5,
                       max_det: int = 300, pre_nms: int = DEFAULT_PRE_NMS,
                       compute_dtype: torch.dtype | None = None,
                       device=None) -> ServingStep:
    """The TileEngine's step over `predictor.prepare_model`'s inference
    model of `model` (BN folded, cast to `compute_dtype`, on `device`:
    CUDA unless "cpu" is asked for; None: the model's own dtype, or
    predictor.COMPUTE_DTYPE).  LITERALLY the engine's step: both call
    parallel.engine.make_tile_step, so serving and the live engine cannot
    drift."""
    from caesar_yolo_tpu_torch.detect.predictor import prepare_model
    from caesar_yolo_tpu_torch.parallel.engine import make_tile_step
    from caesar_yolo_tpu_torch.utils.device import resolve_device

    prepared = prepare_model(model, dtype=compute_dtype,
                             device=resolve_device(device))
    step = make_tile_step(prepared, preprocessor=preprocessor,
                          img_size=img_size, score_thr=score_thr,
                          iou_thr=iou_thr, max_det=max_det, pre_nms=pre_nms)
    return ServingStep(prepared, step).eval()


def platform_of(platforms) -> str:
    """The one device an artifact is exported for: "cuda" (None) or
    "cpu"; more than one is refused."""
    if platforms is None:
        return "cuda"
    names = ((platforms,) if isinstance(platforms, str)
             else tuple(platforms))
    if len(names) != 1:
        raise ValueError(
            f"an artifact holds one device's weights and program: "
            f"torch.export lowers for one device at a time, so export one "
            f"artifact per platform, not {names}")
    if names[0] not in PLATFORMS:
        raise ValueError(f"platform {names[0]!r} is not one of {PLATFORMS}")
    return names[0]


def export_detector(model, *, tile_shape, batch: int, preprocessor=None,
                    img_size: int = 640, score_thr: float = 0.25,
                    iou_thr: float = 0.5, max_det: int = 300,
                    pre_nms: int = DEFAULT_PRE_NMS,
                    compute_dtype: torch.dtype | None = None,
                    platforms=None) -> bytes:
    """The detect step for `batch` f32 tiles of `tile_shape` (H, W, C),
    exported (non-strict, under no_grad) and saved with its weights to
    bytes.  `platforms`: "cuda" (default) or "cpu"; `compute_dtype` as
    build_serving_step's."""
    device = platform_of(platforms)
    step = build_serving_step(
        model, preprocessor=preprocessor, img_size=img_size,
        score_thr=score_thr, iou_thr=iou_thr, max_det=max_det,
        pre_nms=pre_nms, compute_dtype=compute_dtype, device=device)
    shape = (int(batch), *(int(d) for d in tile_shape))
    example = torch.zeros(shape, dtype=torch.float32, device=device)
    with torch.no_grad():
        program = torch.export.export(step, (example,), strict=False)
    # torch.export.save would keep the example batch (zeros: 52.4 MB at
    # 32 x 640 x 640 in f32) beside the weights; the artifact needs only
    # its shape, which the program's input holds
    program.example_inputs = None
    meta = {"format": FORMAT_VERSION, "device": device,
            "input_shape": list(shape),
            "input_dtype": "float32"}
    buf = io.BytesIO()
    torch.export.save(program, buf,
                      extra_files={META_FILE: json.dumps(meta)})
    return buf.getvalue()


def artifact_meta(blob: bytes) -> dict:
    """The metadata export_detector recorded in an artifact (device, input
    shape and dtype, format version), read without loading it."""
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        names = [n for n in z.namelist()
                 if n.endswith(f"extra/{META_FILE}")]
        if not names:
            raise ValueError("not an export_detector artifact: no "
                             f"{META_FILE} in it")
        meta = json.loads(z.read(names[0]))
    if meta.get("format") != FORMAT_VERSION:
        raise ValueError(f"artifact format {meta.get('format')} is not "
                         f"{FORMAT_VERSION}")
    return meta


class Detector:
    """A loaded artifact: __call__(tiles) -> the six outputs, device
    tensors.  `tiles` (numpy or a tensor) must have the exported shape
    (`input_shape`, from the program's input); it is moved to the
    artifact's device and input dtype (`dtype`, f32 as exported; the
    record's name of it is `dtype_name`)."""

    def __init__(self, program, meta: dict):
        self.program = program
        self.module = program.module()
        self.device = torch.device(meta["device"])
        self.input_shape, self.dtype = input_spec(program)
        self.dtype_name = str(self.dtype).removeprefix("torch.")
        if (list(self.input_shape) != meta["input_shape"]
                or self.dtype_name != meta["input_dtype"]):
            raise ValueError(
                f"artifact input {self.input_shape} {self.dtype_name} differs "
                f"from its record {meta['input_shape']} {meta['input_dtype']}")

    def __call__(self, tiles):
        tiles = torch.as_tensor(tiles)
        if tuple(tiles.shape) != self.input_shape:
            raise ValueError(f"tile batch of shape {tuple(tiles.shape)}: "
                             f"the artifact takes {self.input_shape}")
        with torch.no_grad():
            return tuple(self.module(tiles.to(self.device, self.dtype)))


def load_detector(blob: bytes) -> Detector:
    """Load an export_detector artifact on the device it was exported for
    (raising when that is CUDA and there is none; it is never moved to the
    CPU)."""
    meta = artifact_meta(blob)
    if meta["device"] == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "this artifact was exported for CUDA and no CUDA device is "
            "available; export one with platforms='cpu' for the CPU")
    register_ops()
    return Detector(torch.export.load(io.BytesIO(blob)), meta)


def input_spec(program) -> tuple[tuple[int, ...], torch.dtype]:
    """(shape, dtype) of an ExportedProgram's one user input, from its
    placeholder's recorded value."""
    (name,) = program.graph_signature.user_inputs
    node = next(n for n in program.graph.nodes
                if n.op == "placeholder" and n.name == name)
    val = node.meta["val"]
    return tuple(int(d) for d in val.shape), val.dtype


__all__ = ["KERNEL_OPS", "Detector", "ServingStep",
           "artifact_meta", "build_serving_step", "export_detector",
           "input_spec", "load_detector", "platform_of", "register_ops"]
