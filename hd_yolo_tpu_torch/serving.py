"""REST serving on the port's ``Detector`` (port of ``hd_yolo_tpu/serving.py``).

POST an image (multipart with a file, or the raw bytes) to
``/v1/object-detection/<model>`` for tile records, or to
``/v1/slide/<model>`` for tiled whole-slide inference with records in slide
coordinates; ``?task=<tag>`` selects a header of a multi-task model;
``GET /healthz`` answers ``{"status": "ok"}``.  Uses the stdlib
``http.server``; put it behind a proper WSGI/ASGI runner in production.

Run: ``python -m hd_yolo_tpu_torch.serving --weights model.pt --port 5000``
(on the card; ``--device cpu`` for the plain path).
POST: ``curl -F image=@tile.png http://host:5000/v1/object-detection/hd_yolo``

``_respond(img, is_slide, task)`` is the request path after the image
decode (OpenCV, imported in the handler), so it can be driven without it.
An unknown ``?task=`` raises inside the handler and the client sees the
connection dropped, as the JAX server does.
"""

from __future__ import annotations

import argparse
import json
import re
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np

from . import LOGGER
from .detector import Detector

_detector: Optional[Detector] = None


def _parse_multipart(body: bytes, content_type: str) -> Optional[bytes]:
    m = re.search(r'boundary="?([^";,]+)"?', content_type)
    if not m:
        return None
    boundary = ("--" + m.group(1)).encode()
    for part in body.split(boundary):
        if b"filename=" in part:
            idx = part.find(b"\r\n\r\n")
            if idx >= 0:
                return part[idx + 4:].rstrip(b"\r\n-")
    return None


def _respond(img: np.ndarray, is_slide: bool, task: Optional[str]) -> Tuple[int, list]:
    """A decoded RGB image through the served detector → (HTTP code, records)."""
    if is_slide:
        # tiled whole-slide inference, records in slide coordinates
        results = _detector.slide(img, mask_uint8=True, **({"task": task} if task else {}))
    else:
        results = _detector(img, **({"task": task} if task else {}))
    return 200, results.to_records()


class Handler(BaseHTTPRequestHandler):
    def _send(self, code: int, payload):
        data = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        if self.path == "/healthz":
            self._send(200, {"status": "ok"})
        else:
            self._send(404, {"error": "not found"})

    def do_POST(self):
        is_slide = self.path.startswith("/v1/slide")
        if not (is_slide or self.path.startswith("/v1/object-detection")):
            self._send(404, {"error": "not found"})
            return
        task = None
        if "?" in self.path:
            from urllib.parse import parse_qs, urlparse

            task = parse_qs(urlparse(self.path).query).get("task", [None])[0]
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        ctype = self.headers.get("Content-Type", "")
        img_bytes = _parse_multipart(body, ctype) if "multipart" in ctype else body
        if not img_bytes:
            self._send(400, {"error": "no image provided"})
            return
        try:
            import cv2

            arr = cv2.imdecode(np.frombuffer(img_bytes, np.uint8), cv2.IMREAD_COLOR)
            if arr is None:
                raise ValueError("decode failed")
            img = cv2.cvtColor(arr, cv2.COLOR_BGR2RGB)
        except Exception as e:
            self._send(400, {"error": f"bad image: {e}"})
            return
        self._send(*_respond(img, is_slide, task))

    def log_message(self, fmt, *args):  # route to our logger
        LOGGER.debug("serving: " + fmt % args)


def serve(detector: Detector, host: str = "0.0.0.0", port: int = 5000):
    global _detector
    _detector = detector
    server = ThreadingHTTPServer((host, port), Handler)
    LOGGER.info(f"serving on http://{host}:{port}/v1/object-detection")
    server.serve_forever()


def main(argv=None):
    p = argparse.ArgumentParser("hd_yolo_tpu_torch REST server")
    p.add_argument("--cfg", default="yolov5l6-mask")
    p.add_argument("--hyp", default="hyp-nuclei")
    p.add_argument("--weights", default=None)
    p.add_argument("--input-size", type=int, default=640)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=5000)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    opt = p.parse_args(argv)
    serve(Detector(opt.cfg, opt.hyp, opt.weights, input_size=opt.input_size, device=opt.device),
          opt.host, opt.port)


if __name__ == "__main__":
    main()
