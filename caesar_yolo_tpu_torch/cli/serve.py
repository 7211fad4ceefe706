"""Detection server: serve a frozen artifact over HTTP.

    python -m caesar_yolo_tpu_torch.cli.serve --artifact=det.cyx [--port=8080]

Counterpart of caesar_yolo_tpu/cli/serve.py.  Loads a `cli.export`
artifact (deploy.load_detector: no model code, no weights) on the device
it was exported for (`cli.export --platforms=cpu` for the CPU) and
answers detection requests:

  POST /detect   body: raw little-endian float32 tile batch of the
                 artifact's shape (B, H, W, C), or a .npy file of that
                 shape.  Response: JSON {"detections": [per-tile
                 {boxes, scores, class_ids}], "tile_ok": [...],
                 "n_dropped": [...]}; 400 on a size or shape mismatch.
  GET  /healthz  {"status", "input_shape", "dtype"}.

Built on the stdlib only.  Single-threaded, as the reference's: requests
are served one after another on one device, and the batch dimension is
the throughput lever, not concurrency.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import torch

from caesar_yolo_tpu_torch import logger


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="caesar-yolo-tpu serving daemon (PyTorch port)")
    p.add_argument("--artifact", required=True,
                   help="cli.export artifact file (.cyx)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    return p.parse_args(argv)


def read_tiles(raw: bytes, in_shape) -> np.ndarray:
    """A request body (raw little-endian f32 or .npy) -> f32 tiles of
    `in_shape`; ValueError on a size or shape mismatch."""
    if raw[:6] == b"\x93NUMPY":
        tiles = np.load(io.BytesIO(raw))
    else:
        n_bytes = int(np.prod(in_shape)) * 4
        if len(raw) != n_bytes:
            raise ValueError(f"expected {n_bytes} raw f32 bytes for shape "
                             f"{tuple(in_shape)}, got {len(raw)}")
        tiles = np.frombuffer(raw, "<f4").reshape(in_shape)
    if tuple(tiles.shape) != tuple(in_shape):
        raise ValueError(f"tile shape {tiles.shape} != artifact shape "
                         f"{tuple(in_shape)}")
    return np.array(tiles, np.float32)          # a writable copy


def detections_json(outputs) -> dict:
    """The six outputs of one batch -> the response's JSON object."""
    boxes, scores, cls, valid, tile_ok, ndrop = (
        t.cpu().numpy() for t in outputs)
    dets = [{"boxes": boxes[i][v].astype(float).tolist(),
             "scores": scores[i][v].astype(float).tolist(),
             "class_ids": cls[i][v].astype(int).tolist()}
            for i, v in enumerate(valid)]
    return {"detections": dets, "tile_ok": tile_ok.astype(bool).tolist(),
            "n_dropped": ndrop.astype(int).tolist()}


def make_handler(det):
    in_shape = det.input_shape

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # through the package logger
            logger.debug("serve: " + fmt, *args)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok",
                                  "input_shape": list(in_shape),
                                  "dtype": det.dtype_name})
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/detect":
                self._reply(404, {"error": "unknown path"})
                return
            length = int(self.headers.get("Content-Length", "0"))
            try:
                tiles = read_tiles(self.rfile.read(length), in_shape)
            except Exception as e:
                self._reply(400, {"error": str(e)})
                return
            self._reply(200, detections_json(det(torch.from_numpy(tiles))))

    return Handler


def build_server(artifact_path: str, host: str, port: int) -> HTTPServer:
    """Load the artifact, run it once, and return a ready HTTPServer
    (serve_forever() to run; tests drive it from a thread)."""
    from caesar_yolo_tpu_torch.deploy import load_detector

    with open(artifact_path, "rb") as f:
        det = load_detector(f.read())
    warm = det(torch.zeros(det.input_shape))
    [t.cpu() for t in warm]                  # wait for the first run
    logger.info("Serving %s (input %s, %s) on %s:%d", artifact_path,
                det.input_shape, det.device, host, port)
    return HTTPServer((host, port), make_handler(det))


def main(argv=None) -> int:
    args = parse_args(argv)
    server = build_server(args.artifact, args.host, args.port)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        logger.info("Shutting down")
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
