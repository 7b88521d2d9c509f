"""Pose-estimation server for the image model, on the card.

Counterpart of the image path of ``unipose_tpu/cli/serve.py``: the model is
built in-process (random init from seed 0, or ``--pretrained`` reference
weights), runs in bf16, and takes raw uint8 pixels that are normalised on
the card.  Concurrent requests are grouped by a ``MicroBatcher`` and run at
their real batch size (no padding to a static batch).

Endpoints:
  GET  /healthz  -> {"status": "ok", "kind": "image", ...}
  POST /predict  body = JPEG/PNG bytes
                 -> {"keypoints": [[x, y], ...K], "ms": float}
     keypoints are per-channel heatmap argmaxes scaled back to the
     image's pixels (the demo path's get_kpts semantics).

Usage:
  python -m unipose_tpu_torch.cli.serve --dataset LSP [--pretrained w.pth.tar]
"""

from __future__ import annotations

import argparse
import json
import threading
import time

import numpy as np
import torch

from unipose_tpu_torch import resolve_device
from unipose_tpu_torch.core.config import DATASETS, ModelConfig
from unipose_tpu_torch.train.steps import preprocess_images


class MicroBatcher:
    """Group concurrent single-image requests into one model call.

    A dispatcher thread drains up to ``batch`` queued requests per call
    (waiting ``wait_ms`` for stragglers once one is pending) and fans the
    results back out.  An error raised by a call reaches that call's
    requests only.  With batch 1 it is a FIFO that serialises device access.
    """

    def __init__(self, call, batch: int, wait_ms: float = 2.0):
        self.call = call
        self.batch = int(batch)
        self.wait = (wait_ms / 1e3) if self.batch > 1 else 0.0
        self._cv = threading.Condition()
        self._queue = []
        threading.Thread(target=self._run, daemon=True).start()

    def infer(self, x: np.ndarray) -> np.ndarray:
        """x: one (H, W, 3) image -> its (h, w, K+1) heatmaps."""
        item = {"x": x, "done": threading.Event(), "out": None, "err": None}
        with self._cv:
            self._queue.append(item)
            self._cv.notify()
        item["done"].wait()
        if item["err"] is not None:
            raise item["err"]
        return item["out"]

    def _run(self):
        while True:
            with self._cv:
                while not self._queue:
                    self._cv.wait()
                if self.wait:  # let concurrent requests join until deadline
                    deadline = time.monotonic() + self.wait
                    while len(self._queue) < self.batch:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cv.wait(remaining)
                items = self._queue[: self.batch]
                del self._queue[: self.batch]
            try:
                heat = np.asarray(self.call(np.stack([it["x"] for it in items])))
                for i, it in enumerate(items):
                    it["out"] = heat[i]
            except Exception as e:  # noqa: BLE001 — fan the error out
                for it in items:
                    it["err"] = e
            for it in items:
                it["done"].set()


def _argmax_kpts(heat: np.ndarray, num_joints: int, w0: int, h0: int):
    """Per-channel argmax (channel 0 = background) of (h, w, K+1) heatmaps,
    scaled to original pixels — the demo path's get_kpts semantics
    (utils/utils.py:94-106)."""
    hh, ww = heat.shape[:2]
    kpts = []
    for k in range(1, num_joints + 1):
        idx = int(np.argmax(heat[..., k]))
        y, x = divmod(idx, ww)
        kpts.append([round(x * w0 / ww, 2), round(y * h0 / hh, 2)])
    return kpts


def build_handler(predict_routes: dict, meta: dict):
    """HTTP handler factory; ``predict_routes`` maps path -> fn(body)->dict."""
    import http.server

    class Handler(http.server.BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok", **meta})
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            fn = predict_routes.get(self.path)
            if fn is None:
                self._send(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                self._send(200, fn(self.rfile.read(n)))
            except Exception as e:  # noqa: BLE001 — surface as 400
                self._send(400, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return Handler


def _decode_image(buf: bytes) -> np.ndarray:
    import cv2

    img = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError("body is not a decodable image")
    return img


def _resize(img: np.ndarray, size: int) -> np.ndarray:
    if img.shape[:2] == (size, size):
        return img
    import cv2

    return cv2.resize(img, (size, size))


class ImageService:
    """The model behind a ``MicroBatcher``, and the request functions."""

    def __init__(self, model, *, size: int, num_joints: int, batch: int = 1, wait_ms: float = 2.0):
        self.model = model
        self.size = int(size)
        self.num_joints = int(num_joints)
        self.device = next(model.parameters()).device
        self.batcher = MicroBatcher(self._call, batch, wait_ms=wait_ms)
        self.meta = {
            "kind": "image",
            "input": [int(batch), self.size, self.size, 3],
            "input_dtype": "uint8",
            "num_joints": self.num_joints,
            "batch": int(batch),
            "device": str(self.device),
        }

    @torch.no_grad()
    def _call(self, xs: np.ndarray) -> np.ndarray:
        """(n, H, W, 3) uint8 -> (n, h, w, K+1) f32 heatmaps."""
        x = torch.from_numpy(xs).to(self.device)
        x = preprocess_images(x).permute(0, 3, 1, 2)  # NCHW, channels-last memory
        return self.model(x).permute(0, 2, 3, 1).cpu().numpy()

    def predict_image(self, img: np.ndarray) -> dict:
        """One decoded H x W x 3 uint8 image -> its keypoints."""
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"expected an H x W x 3 uint8 image, got {img.dtype} {img.shape}")
        h0, w0 = img.shape[:2]
        x = _resize(img, self.size)
        t0 = time.perf_counter()
        heat = self.batcher.infer(x)
        dt = (time.perf_counter() - t0) * 1e3
        return {
            "keypoints": _argmax_kpts(heat, self.num_joints, w0, h0),
            "ms": round(dt, 2),
        }

    def predict(self, body: bytes) -> dict:
        return self.predict_image(_decode_image(body))


def http_server(service: ImageService, host: str, port: int):
    """A ThreadingHTTPServer for ``service`` (``server.service`` keeps it)."""
    import http.server

    handler = build_handler({"/predict": service.predict}, service.meta)
    server = http.server.ThreadingHTTPServer((host, port), handler)
    server.service = service
    return server


def make_server(args):
    """Build the model and its HTTP server (separated from main for tests).
    Runs on the card unless ``args.device`` names another device."""
    from unipose_tpu_torch.compat.torch_convert import (
        load_state_dict_intersection,
        load_torch_checkpoint,
    )
    from unipose_tpu_torch.models.unipose import init_model

    device = resolve_device(getattr(args, "device", None))
    spec = DATASETS[args.dataset]
    config = ModelConfig(
        dataset=args.dataset, num_classes=spec.num_joints, compute_dtype=torch.bfloat16
    )
    model = init_model(config, seed=0, device=device)
    if args.pretrained:
        report = load_state_dict_intersection(model, load_torch_checkpoint(args.pretrained))
        print(f"warm start: loaded {len(report['loaded'])} tensors, "
              f"skipped {len(report['skipped'])}")
    service = ImageService(
        model, size=args.size, num_joints=spec.num_joints,
        batch=args.batch, wait_ms=args.batch_wait_ms,
    )
    return http_server(service, args.host, args.port)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="unipose_tpu_torch image server")
    p.add_argument("--dataset", default="LSP", choices=sorted(DATASETS))
    p.add_argument("--pretrained", default=None, help="reference *.pth.tar")
    p.add_argument("--size", type=int, default=368, help="model input size")
    p.add_argument("--batch", type=int, default=1, help="largest micro-batch")
    p.add_argument(
        "--batch_wait_ms", type=float, default=2.0,
        help="micro-batching: wait this long for concurrent requests",
    )
    p.add_argument("--device", default=None, help="default: the CUDA card")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8500)
    return p.parse_args(argv)


def main(argv=None):
    server = make_server(parse_args(argv))
    print(f"serving on http://{server.server_address[0]}:{server.server_address[1]}")
    server.serve_forever()


if __name__ == "__main__":
    main()
