"""Pose-estimation server for the image and video models, on the card.

Counterpart of ``unipose_tpu/cli/serve.py``.  Two ways to serve:

* ``--artifact``: a program exported by ``cli/export.py``
  (``compat/export.py``; weights baked in, loaded without the model code),
  as the JAX server serves its StableHLO artifacts.  Geometry, input dtype
  (uint8 for ``--raw_uint8`` artifacts, else normalised f32, which the
  server computes on the host), joint count and baked batch are read from
  the program itself; requests are padded to the baked batch.  Image and
  clip artifacts micro-batch concurrent requests up to it; a streaming
  artifact runs its init program, then its cont program, with each
  client's ConvLSTM state carried between chunks.  The artifact runs where
  it was exported (``--device``, the card by default).
* in-process (no ``--artifact``): the model is built here (random init
  from seed 0, or ``--pretrained`` reference weights), runs in bf16, and
  takes raw uint8 pixels that are normalised on the card.  Concurrent
  requests are grouped by a ``MicroBatcher`` and run at their real batch
  size (no padding to a static batch).

Endpoints:
  GET  /healthz        -> {"status": "ok", "kind": "image"|"video"|"video_stream", ...}
  POST /predict        body = JPEG/PNG bytes (image model)
                       -> {"keypoints": [[x, y], ...K], "ms": float}
  POST /predict_video  body = {"frames": ["<b64 jpeg>", ...]} (video model)
                       -> {"keypoints": [[[x, y], ...K], ...T], "ms": float}
     keypoints are per-channel heatmap argmaxes scaled back to the
     image's pixels (the demo path's get_kpts semantics).

Video serving in-process (``--model_arch uniposeLSTM``) has two modes:
  * clip (default): a clip of at most ``--frame_memory`` frames, padded by
    repeating its last frame; concurrent clips micro-batch up to ``--batch``;
  * ``--stream``: a clip of any length, run in ``--frame_memory`` chunks with
    the ConvLSTM state carried from chunk to chunk.  Each request's state is
    its own, so requests are not coalesced; chunk calls reach the card
    through one FIFO.
The centermap is a sigma-3 Gaussian at the frame centre, built once.  An
artifact's clips are decoded by the native batch decoder
(``native.decode_batch_mem``, byte for byte the cv2 route's frames) where
it builds, else by cv2; the server prints which.

Usage:
  python -m unipose_tpu_torch.cli.serve --artifact model.pt2 [--num_joints K] [--device cpu]
  python -m unipose_tpu_torch.cli.serve --dataset LSP [--pretrained w.pth.tar]
  python -m unipose_tpu_torch.cli.serve --dataset Penn_Action \\
      --model_arch uniposeLSTM --frame_memory 5 [--stream]
"""

from __future__ import annotations

import argparse
import base64
import json
import threading
import time

import numpy as np
import torch

from unipose_tpu_torch import resolve_device
from unipose_tpu_torch.core.config import DATASETS, ModelConfig
from unipose_tpu_torch.train.steps import preprocess_images


class MicroBatcher:
    """Group concurrent requests (images, or clips) into one model call.

    A dispatcher thread drains up to ``batch`` queued requests per call
    (waiting ``wait_ms`` for stragglers once one is pending), hands
    ``stack`` of their inputs to ``call``, and fans the results (indexable
    by request) back out.  An error raised by a call reaches that call's
    requests only.  With batch 1 it is a FIFO that serialises device access.
    """

    def __init__(self, call, batch: int, wait_ms: float = 2.0, stack=np.stack):
        self.call = call
        self.stack = stack
        self.batch = int(batch)
        self.wait = (wait_ms / 1e3) if self.batch > 1 else 0.0
        self._cv = threading.Condition()
        self._queue = []
        threading.Thread(target=self._run, daemon=True).start()

    def infer(self, x):
        """x: one request's input (an (H, W, 3) image) -> its result (the
        image's (h, w, K+1) heatmaps)."""
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
                outs = self.call(self.stack([it["x"] for it in items]))
                for i, it in enumerate(items):
                    it["out"] = outs[i]
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


def _centermaps(b: int, t: int, size: int) -> np.ndarray:
    """(B, T, H, W, 1) sigma-3 Gaussian at the frame centre, unclamped: the
    JAX server's centermap (serve.py:117-124)."""
    ys, xs = np.mgrid[:size, :size].astype(np.float32)
    c = (size - 1) / 2.0
    g = np.exp(-((xs - c) ** 2 + (ys - c) ** 2) / (2.0 * 3.0**2))
    return np.broadcast_to(g[None, None, :, :, None], (b, t, size, size, 1)).copy()


def _pad_frames(frames: np.ndarray, t: int) -> np.ndarray:
    """(n, H, W, 3) -> (t, H, W, 3), repeating the last frame."""
    if frames.shape[0] < t:
        frames = np.concatenate([frames, np.repeat(frames[-1:], t - frames.shape[0], axis=0)])
    return frames


class VideoService:
    """The video model and the request function of ``/predict_video``.

    Clip mode: a clip of at most ``clip_t`` frames, padded to ``clip_t``;
    concurrent clips micro-batch up to ``batch``.  Stream mode: any length,
    in ``clip_t`` chunks with (cell, hide) carried per request; every chunk
    call goes through one FIFO (a ``MicroBatcher`` of batch 1)."""

    def __init__(self, model, *, size: int, num_joints: int, clip_t: int, stream: bool = False,
                 batch: int = 1, wait_ms: float = 2.0):
        self.model = model
        self.size = int(size)
        self.num_joints = int(num_joints)
        self.clip_t = int(clip_t)
        self.stream = bool(stream)
        self.device = next(model.parameters()).device
        batch = 1 if stream else int(batch)
        cm = torch.from_numpy(_centermaps(batch, self.clip_t, self.size)).to(self.device)
        self.centermap = cm.permute(0, 1, 4, 2, 3)  # (batch, T, 1, H, W), kept on the card
        if stream:
            self.batcher = MicroBatcher(lambda calls: [calls[0]()], 1, stack=list)
        else:
            self.batcher = MicroBatcher(self._call_clips, batch, wait_ms=wait_ms)
        self.meta = {
            "kind": "video_stream" if stream else "video",
            "input": [batch, self.clip_t, self.size, self.size, 3],
            "input_dtype": "uint8",
            "num_joints": self.num_joints,
            "batch": batch,
            "device": str(self.device),
        }

    @torch.no_grad()
    def _run(self, clips: np.ndarray, state=None):
        """(n, T, H, W, 3) uint8 -> ((n, T, h, w, K+1) f32 on the host, state)."""
        x = preprocess_images(torch.from_numpy(clips).to(self.device)).permute(0, 1, 4, 2, 3)
        heat, state = self.model(x, self.centermap[: len(clips)], initial_state=state)
        return heat.permute(0, 1, 3, 4, 2).cpu().numpy(), state

    def _call_clips(self, clips: np.ndarray) -> np.ndarray:
        return self._run(clips)[0]

    def predict_frames(self, frames) -> dict:
        """Decoded H x W x 3 uint8 frames of one clip -> their keypoints."""
        if not frames or any(f.dtype != np.uint8 or f.ndim != 3 or f.shape[2] != 3 for f in frames):
            raise ValueError("expected a non-empty list of H x W x 3 uint8 frames")
        t_real = len(frames)
        if not self.stream and t_real > self.clip_t:
            raise ValueError(
                f"clip too long: {t_real} frames > clip length {self.clip_t} "
                "(serve with --stream to serve long videos)"
            )
        dims = [(f.shape[1], f.shape[0]) for f in frames]  # (w0, h0)
        clip = np.stack([_resize(f, self.size) for f in frames])
        t0 = time.perf_counter()
        if self.stream:
            heats, state = [], None
            for start in range(0, t_real, self.clip_t):
                chunk = _pad_frames(clip[start : start + self.clip_t], self.clip_t)[None]
                heat, state = self.batcher.infer(lambda c=chunk, s=state: self._run(c, s))
                heats.append(heat[0])
            heat = np.concatenate(heats)
        else:
            heat = self.batcher.infer(_pad_frames(clip, self.clip_t))
        dt = (time.perf_counter() - t0) * 1e3
        return {
            "keypoints": [_argmax_kpts(heat[j], self.num_joints, *dims[j]) for j in range(t_real)],
            "ms": round(dt, 2),
        }

    def predict(self, body: bytes) -> dict:
        frames_b64 = json.loads(body).get("frames")
        if not isinstance(frames_b64, list) or not frames_b64:
            raise ValueError('body must be {"frames": ["<b64 jpeg>", ...]}')
        return self.predict_frames([_decode_image(base64.b64decode(f)) for f in frames_b64])


def clip_decode_route() -> str:
    """"native" when the C++ decode core builds and loads here, else "cv2":
    a choice of host route, as the data loaders make it."""
    from unipose_tpu_torch import native

    return "native" if native.available() else "cv2"


def decode_clip(frames_b64, size: int, route: str):
    """A request's base64 JPEG frames -> ((T, size, size, 3) uint8 frames,
    [(w0, h0)] per frame), by the native batch decoder (one call for the
    clip, on its thread pool) or frame by frame with cv2; the two give the
    same bytes."""
    if not isinstance(frames_b64, list) or not frames_b64:
        raise ValueError('body must be {"frames": ["<b64 jpeg>", ...]}')
    bufs = [base64.b64decode(f) for f in frames_b64]
    if route == "native":
        from unipose_tpu_torch import native

        out, statuses, dims = native.decode_batch_mem(bufs, size, return_dims=True)
        bad = np.nonzero(statuses)[0]
        if bad.size:
            raise ValueError(f"frame {int(bad[0])} is not a decodable image")
        return out.astype(np.uint8), [(int(c), int(r)) for r, c in dims]
    imgs = [_decode_image(b) for b in bufs]
    return np.stack([_resize(im, size) for im in imgs]), [(im.shape[1], im.shape[0]) for im in imgs]


def _host_normalise(x: np.ndarray) -> np.ndarray:
    """(x - 128) / 256 in f32 on the host, for an artifact that takes
    normalised f32 (the JAX server's host-side preprocess)."""
    return (x.astype(np.float32) - 128.0) / 256.0


def _pad_batch(xs: np.ndarray, batch: int) -> np.ndarray:
    """Pad the batch dim to the artifact's static ``batch`` by repeating the
    last entry."""
    if len(xs) < batch:
        xs = np.concatenate([xs, np.repeat(xs[-1:], batch - len(xs), axis=0)])
    return xs


class ArtifactService:
    """An exported program (image, clip, or a streaming pair) behind the
    request functions.  Everything about its inputs is read from the
    program: geometry, dtype, baked batch and (from its first output) the
    joint count."""

    def __init__(self, blob: bytes, *, device, num_joints=None, wait_ms: float = 2.0):
        from unipose_tpu_torch.compat.export import (
            input_specs,
            is_stream_artifact,
            load_exported,
            load_video_stream,
            output_specs,
        )

        self.device = torch.device(device)
        self.stream = is_stream_artifact(blob)
        if self.stream:
            init, cont = load_video_stream(blob, self.device)
            self.init, self.cont, ep = init.module(), cont.module(), init
        else:
            ep = load_exported(blob, self.device)
            self.program = ep.module()
        specs = input_specs(ep)
        self.video = self.stream or (len(specs) == 2 and len(specs[0][0]) == 5)
        if not self.video and (len(specs) != 1 or len(specs[0][0]) != 4):
            raise SystemExit(
                "serve expects an image artifact with one (B, H, W, 3) input or a video "
                "artifact with (B, T, H, W, 3) + centermap inputs; got "
                f"{len(specs)} input(s) {[s[0] for s in specs]}"
            )
        in_shape, in_dtype = specs[0]
        self.raw_u8 = in_dtype == torch.uint8
        self.batch = int(in_shape[0])
        self.size = int(in_shape[2] if self.video else in_shape[1])
        derived = int(output_specs(ep)[0][0][-1]) - 1
        if num_joints is None:
            num_joints = derived
        elif num_joints > derived:
            raise SystemExit(
                f"--num_joints {num_joints} exceeds the artifact's {derived} joint channels: "
                "every request would fail; drop the flag to take the count from the artifact"
            )
        self.num_joints = int(num_joints)
        self.meta = {
            "kind": ("video_stream" if self.stream else "video") if self.video else "image",
            "input": list(in_shape),
            "input_dtype": "uint8" if self.raw_u8 else "float32",
            "num_joints": self.num_joints,
            "batch": self.batch,
            "artifact_bytes": len(blob),
            "device": str(self.device),
        }
        if self.video:
            self.clip_t = int(in_shape[1])
            cm = _centermaps(self.batch, self.clip_t, self.size)
            self.centermap = torch.from_numpy(cm).to(self.device)
            self.decode_route = clip_decode_route()
            print(f"clip decode route: {self.decode_route}", flush=True)
        if self.stream:  # each client's state is its own: chunk calls go through one FIFO
            self.batcher = MicroBatcher(lambda calls: [calls[0]()], 1, stack=list)
        else:
            self.batcher = MicroBatcher(self._call, self.batch, wait_ms=wait_ms)

    def _input(self, xs: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(_pad_batch(xs, self.batch)).to(self.device)

    @torch.no_grad()
    def _call(self, xs: np.ndarray) -> np.ndarray:
        """n <= batch requests (images, or clips) -> their heatmaps."""
        args = (self._input(xs),) + ((self.centermap,) if self.video else ())
        return self.program(*args)[: len(xs)].cpu().numpy()

    @torch.no_grad()
    def _chunk(self, chunk: np.ndarray, state):
        """One (T, H, W, 3) chunk of one client's clip -> its (T, h, w, K+1)
        heatmaps and the new state."""
        x = self._input(chunk[None])
        heat, cell, hide = (self.init(x, self.centermap) if state is None
                            else self.cont(x, self.centermap, *state))
        return heat[0].cpu().numpy(), (cell, hide)

    def _wire(self, x: np.ndarray) -> np.ndarray:
        return x if self.raw_u8 else _host_normalise(x)

    def predict_image(self, img: np.ndarray) -> dict:
        h0, w0 = img.shape[:2]
        x = self._wire(_resize(img, self.size))
        t0 = time.perf_counter()
        heat = self.batcher.infer(x)
        dt = (time.perf_counter() - t0) * 1e3
        return {"keypoints": _argmax_kpts(heat, self.num_joints, w0, h0), "ms": round(dt, 2)}

    def predict_clip(self, frames: np.ndarray, dims) -> dict:
        """(T, size, size, 3) uint8 frames of one clip and their original
        (w0, h0) -> keypoints a frame."""
        t_real = len(dims)
        if not self.stream and t_real > self.clip_t:
            raise ValueError(
                f"clip too long: {t_real} frames > artifact clip length {self.clip_t} "
                "(export a streaming artifact with cli/export --stream to serve long videos)"
            )
        t0 = time.perf_counter()
        if self.stream:
            heats, state = [], None
            for start in range(0, t_real, self.clip_t):
                chunk = self._wire(_pad_frames(frames[start : start + self.clip_t], self.clip_t))
                heat, state = self.batcher.infer(lambda c=chunk, s=state: self._chunk(c, s))
                heats.append(heat)
            heat = np.concatenate(heats)
        else:
            heat = self.batcher.infer(self._wire(_pad_frames(frames, self.clip_t)))
        dt = (time.perf_counter() - t0) * 1e3
        return {
            "keypoints": [_argmax_kpts(heat[j], self.num_joints, *dims[j]) for j in range(t_real)],
            "ms": round(dt, 2),
        }

    def predict(self, body: bytes) -> dict:
        if not self.video:
            return self.predict_image(_decode_image(body))
        frames, dims = decode_clip(json.loads(body).get("frames"), self.size, self.decode_route)
        return self.predict_clip(frames, dims)


def http_server(service, host: str, port: int):
    """A ThreadingHTTPServer for an ``ImageService``, a ``VideoService`` or
    an ``ArtifactService`` (``server.service`` keeps it)."""
    import http.server

    video = isinstance(service, VideoService) or getattr(service, "video", False)
    route = "/predict_video" if video else "/predict"
    handler = build_handler({route: service.predict}, service.meta)
    server = http.server.ThreadingHTTPServer((host, port), handler)
    server.service = service
    return server


def make_server(args):
    """Build the model, or load ``args.artifact``, and the HTTP server
    (separated from main for tests).  Runs on the card unless
    ``args.device`` names another device."""
    device = resolve_device(getattr(args, "device", None))
    if getattr(args, "artifact", None):
        with open(args.artifact, "rb") as f:
            blob = f.read()
        service = ArtifactService(
            blob, device=device, num_joints=getattr(args, "num_joints", None),
            wait_ms=getattr(args, "batch_wait_ms", 2.0),
        )
        return http_server(service, args.host, args.port)

    from unipose_tpu_torch.compat.torch_convert import (
        load_state_dict_intersection,
        load_torch_checkpoint,
    )
    from unipose_tpu_torch.models.unipose import init_model

    spec = DATASETS[args.dataset]
    video = args.model_arch == "uniposeLSTM"
    config = ModelConfig(
        dataset=args.dataset, num_classes=spec.num_joints, compute_dtype=torch.bfloat16,
        variant="lstm" if video else "image", frame_memory=args.frame_memory,
    )
    model = init_model(config, seed=0, device=device)
    if args.pretrained:
        report = load_state_dict_intersection(model, load_torch_checkpoint(args.pretrained))
        print(f"warm start: loaded {len(report['loaded'])} tensors, "
              f"skipped {len(report['skipped'])}")
    if video:
        service = VideoService(
            model, size=args.size, num_joints=spec.num_joints, clip_t=args.frame_memory,
            stream=args.stream, batch=args.batch, wait_ms=args.batch_wait_ms,
        )
    else:
        service = ImageService(
            model, size=args.size, num_joints=spec.num_joints,
            batch=args.batch, wait_ms=args.batch_wait_ms,
        )
    return http_server(service, args.host, args.port)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="unipose_tpu_torch pose server")
    p.add_argument(
        "--artifact", default=None,
        help="a cli/export.py artifact to serve (input size, clip length, joint count and "
        "batch are read from it; the model flags below are then unused)",
    )
    p.add_argument("--num_joints", type=int, default=None,
                   help="artifact: joints to decode (at most the artifact's)")
    p.add_argument("--dataset", default="LSP", choices=sorted(DATASETS))
    p.add_argument("--model_arch", default="unipose", choices=("unipose", "uniposeLSTM"))
    p.add_argument("--frame_memory", type=int, default=5,
                   help="video: frames a clip (clip mode) or a chunk (--stream)")
    p.add_argument("--stream", action="store_true",
                   help="video: clips of any length, ConvLSTM state carried across chunks")
    p.add_argument("--pretrained", default=None, help="reference *.pth.tar")
    p.add_argument("--size", type=int, default=368, help="model input size")
    p.add_argument("--batch", type=int, default=1, help="largest micro-batch (images or clips)")
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
