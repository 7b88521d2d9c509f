"""``cli/serve.py --artifact`` on video artifacts: twins of
tests/test_serve.py::test_serve_video_clip, ::test_video_clips_micro_batch,
::test_serve_streaming_video and ::test_serve_streaming_concurrent_clients
(a short clip padded, a long one refused, concurrent clips in one call, a
stream across chunks equal to the chunk programs run by hand and to what
each client gets alone), and the clip decode's native and cv2 routes byte
for byte.  Keypoints are checked against the JAX server's decode
(``unipose_tpu/cli/serve.py::_argmax_kpts``).
"""

import base64
import json

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from torch_parity import (  # two_threads_for_the_module: an autouse fixture; noqa: E402
    SIZE,
    artifact_server,
    clip_body,
    export_artifact,
    in_frame,
    jpeg,
    post_concurrently,
    serve_args,
    two_threads_for_the_module,
)
from unipose_tpu.cli.serve import _argmax_kpts as jax_argmax_kpts  # noqa: E402
from unipose_tpu_torch.cli import serve  # noqa: E402

__all__ = ["artifact_server"]  # a fixture, used by name


@pytest.fixture(scope="module")
def clip_artifact(tmp_path_factory):
    return export_artifact(tmp_path_factory, "video_b2.pt2", "--dataset", "Penn_Action", "--model_arch",
                   "uniposeLSTM", "--frame_memory", "3", "--batch", "2", "--raw_uint8")


def test_serve_video_clip(clip_artifact, artifact_server):
    """Twins of tests/test_serve.py::test_serve_video_clip and
    ::test_video_clips_micro_batch: a short clip padded, a long one
    refused, no image endpoint, two concurrent clips in one call."""
    srv = artifact_server(serve_args(clip_artifact, batch_wait_ms=200.0))
    health = srv.get()
    assert health["kind"] == "video" and health["input"] == [2, 3, SIZE, SIZE, 3]
    assert health["num_joints"] == 13 and health["input_dtype"] == "uint8"
    status, out = srv.post("/predict_video", clip_body([0, 1]))
    assert status == 200, out
    assert len(out["keypoints"]) == 2 and all(len(k) == 13 and in_frame(k, 100, 80) for k in out["keypoints"])
    status, out = srv.post("/predict_video", clip_body([0, 1, 2, 3]))
    assert status == 400 and "clip too long" in out["error"]
    assert srv.post("/predict", b"x")[0] == 404
    calls = []
    program = srv.service.program
    srv.service.program = lambda *a: calls.append(a[0].shape) or program(*a)
    results = post_concurrently(srv, "/predict_video", [clip_body([5, 6, 7]), clip_body([8, 9])])
    assert [len(out["keypoints"]) for _, out in results] == [3, 2]
    assert len(calls) == 1, calls


@pytest.fixture(scope="module")
def stream_artifact(tmp_path_factory):
    return export_artifact(tmp_path_factory, "stream.pt2", "--dataset", "Penn_Action", "--model_arch",
                   "uniposeLSTM", "--frame_memory", "2", "--stream")


def test_serve_streaming_video(stream_artifact, artifact_server):
    """Twins of tests/test_serve.py::test_serve_streaming_video and
    ::test_serve_streaming_concurrent_clients: a 5-frame clip against
    2-frame chunks, the state carried (the result equals the chunk programs
    run by hand), and two clients at once each get what they get alone."""
    srv = artifact_server(serve_args(stream_artifact))
    health = srv.get()
    assert health["kind"] == "video_stream" and health["input"] == [1, 2, SIZE, SIZE, 3]
    bodies = [clip_body(range(5)), clip_body(range(1000, 1005))]
    serial = [srv.post("/predict_video", b) for b in bodies]
    for status, out in serial:
        assert status == 200, out
        assert len(out["keypoints"]) == 5 and all(len(k) == 13 for k in out["keypoints"])
    assert serial[0][1]["keypoints"] != serial[1][1]["keypoints"]
    concurrent = post_concurrently(srv, "/predict_video", bodies)
    assert [out["keypoints"] for _, out in concurrent] == [out["keypoints"] for _, out in serial]

    svc = srv.service  # the chunks by hand: init, cont, cont (padded)
    frames, dims = serve.decode_clip(json.loads(bodies[0])["frames"], SIZE, svc.decode_route)
    x = (np.concatenate([frames, frames[-1:]]).astype(np.float32) - 128.0) / 256.0
    heats, state = [], None
    for start in range(0, 6, 2):
        chunk = torch.from_numpy(x[None, start : start + 2])
        out = svc.init(chunk, svc.centermap) if state is None else svc.cont(chunk, svc.centermap, *state)
        heats.append(out[0][0].numpy())
        state = out[1:]
    heat = np.concatenate(heats)
    assert serial[0][1]["keypoints"] == [jax_argmax_kpts(heat[j], 13, *dims[j]) for j in range(5)]


def test_clip_decode_routes_agree(capsys):
    """The native batch decoder and cv2 give the same frames byte for byte,
    and the same original sizes (as tests/test_torch_data.py holds the
    loaders' two routes)."""
    from unipose_tpu_torch import native

    if not native.available():
        pytest.skip("the native decode core does not build here (no OpenCV headers)")
    frames_b64 = [base64.b64encode(jpeg(s, shape)).decode()
                  for s, shape in enumerate([(80, 100, 3), (64, 64, 3), (37, 211, 3), (300, 120, 3)])]
    native_frames, native_dims = serve.decode_clip(frames_b64, SIZE, "native")
    cv2_frames, cv2_dims = serve.decode_clip(frames_b64, SIZE, "cv2")
    assert native_frames.dtype == cv2_frames.dtype == np.uint8
    np.testing.assert_array_equal(native_frames, cv2_frames)
    assert native_dims == cv2_dims == [(100, 80), (64, 64), (211, 37), (120, 300)]
    assert serve.clip_decode_route() == "native"
    with pytest.raises(ValueError, match="not a decodable image"):
        serve.decode_clip([base64.b64encode(b"nope").decode()], SIZE, "native")
