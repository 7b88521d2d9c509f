"""The port's video server: a clip over HTTP, a streamed clip that crosses
chunk boundaries against JAX ``stream_video`` and its keypoint decode,
concurrent clips micro-batched, the too-long clip, /healthz, and
``make_server`` with the video flags."""

import base64
import dataclasses
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import perturb_bn, reduced_lstm_depth
from unipose_tpu.cli.serve import _argmax_kpts as jax_argmax_kpts
from unipose_tpu.cli.serve import _centermaps as jax_centermaps
from unipose_tpu.core.config import DATASETS as JAX_DATASETS
from unipose_tpu.eval import video as jax_video
from unipose_tpu.models.unipose_lstm import UniPoseLSTM as JaxUniPoseLSTM
from unipose_tpu_torch.cli import serve
from unipose_tpu_torch.compat.from_jax import state_dict_from_jax
from unipose_tpu_torch.core.config import ModelConfig
from unipose_tpu_torch.models.unipose import build_model, load_numpy_state_dict, random_state_dict

REDUCED = (1, 1, 1, 1)
SIZE = 64
CONFIG = ModelConfig(dataset="Penn_Action", num_classes=13, variant="lstm")


@pytest.fixture(scope="module")
def weights():
    """A JAX UniPoseLSTM at reduced depth and the port's twin (f32, CPU)."""
    with reduced_lstm_depth(REDUCED):
        jmodel = JaxUniPoseLSTM(num_classes=13)
        variables = jax.jit(lambda k, f, c: jmodel.init(k, f, c, train=False))(
            jax.random.PRNGKey(3), jnp.zeros((1, 2, SIZE, SIZE, 3)), jnp.zeros((1, 2, SIZE, SIZE, 1))
        )
    variables = perturb_bn(variables, 4)
    model = build_model(CONFIG, layers=REDUCED)
    model.load_state_dict(state_dict_from_jax(variables, variant="lstm"))
    return jmodel, variables, model.eval()


def _start(service):
    srv = serve.http_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return srv, thread


def _stop(srv, thread):
    srv.shutdown()
    srv.server_close()
    thread.join(10)


@pytest.fixture(scope="module")
def clip_server(weights):
    service = serve.VideoService(weights[2], size=SIZE, num_joints=13, clip_t=3, batch=2, wait_ms=5.0)
    srv, thread = _start(service)
    yield srv
    _stop(srv, thread)


@pytest.fixture(scope="module")
def stream_server(weights):
    service = serve.VideoService(weights[2], size=SIZE, num_joints=13, clip_t=2, stream=True)
    srv, thread = _start(service)
    yield srv
    _stop(srv, thread)


def _frames(n, seed, shape=(SIZE, SIZE, 3)):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, shape).astype(np.uint8) for _ in range(n)]


def _post(srv, frames):
    import cv2

    body = json.dumps(
        {"frames": [base64.b64encode(cv2.imencode(".png", f)[1].tobytes()).decode() for f in frames]}
    ).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.server_address[1]}/predict_video", data=body, method="POST"
    )
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _healthz(srv):
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.server_address[1]}/healthz", timeout=30) as r:
        return json.loads(r.read())


def test_healthz_kinds(clip_server, stream_server):
    meta = _healthz(clip_server)
    assert meta["status"] == "ok" and meta["kind"] == "video"
    assert meta["num_joints"] == 13 and meta["input"] == [2, 3, SIZE, SIZE, 3]
    assert _healthz(stream_server)["kind"] == "video_stream"


def test_clip_over_http(clip_server, weights):
    """A 2-frame clip of 90x120 frames: resized, padded to 3 frames by
    repeating the last, run with the frame-centre centermap; the keypoints
    are the JAX decode of the model's own heatmaps, scaled to 120x90."""
    import cv2

    frames = _frames(2, seed=5, shape=(90, 120, 3))
    got = _post(clip_server, frames)
    clip = np.stack([cv2.resize(f, (SIZE, SIZE)) for f in frames] + [cv2.resize(frames[-1], (SIZE, SIZE))])
    x = (torch.from_numpy(clip[None]).float() - 128.0) / 256.0
    cm = torch.from_numpy(jax_centermaps(1, 3, SIZE)).permute(0, 1, 4, 2, 3)
    with torch.no_grad():
        heat, _ = weights[2](x.permute(0, 1, 4, 2, 3), cm)
    heat = heat.permute(0, 1, 3, 4, 2)[0].numpy()
    assert len(got["keypoints"]) == 2 and got["ms"] > 0
    for j in range(2):
        assert got["keypoints"][j] == jax_argmax_kpts(heat[j], 13, 120, 90)


def test_stream_crosses_chunks_like_jax_stream_video(stream_server, weights, monkeypatch):
    """5 frames in chunks of 2 (the last padded) with the state carried:
    the keypoints of JAX ``stream_video`` on the same frames, fed the
    server's centermap, through the JAX decode."""
    jmodel, variables, _ = weights
    frames = _frames(5, seed=6)
    got = _post(stream_server, frames)
    monkeypatch.setattr(jax_video, "make_centermaps",
                        lambda c, spec: jnp.asarray(jax_centermaps(*c.shape[:2], SIZE)))
    spec = dataclasses.replace(JAX_DATASETS["Penn_Action"], input_size=SIZE)
    with reduced_lstm_depth(REDUCED):
        heat = jax_video.stream_video(
            jmodel, variables["params"], variables["batch_stats"],
            np.stack(frames)[None].astype(np.float32), np.zeros((1, 5, 2), np.float32), spec, chunk=2,
        )[0]
    assert len(got["keypoints"]) == 5
    for j in range(5):
        assert got["keypoints"][j] == jax_argmax_kpts(heat[j], 13, SIZE, SIZE)


def test_concurrent_clips_are_micro_batched(weights):
    """Four concurrent clips against batch 2: two model calls of two clips,
    each clip's keypoints those it gets alone."""
    service = serve.VideoService(weights[2], size=SIZE, num_joints=13, clip_t=3, batch=2, wait_ms=500.0)
    clips = [_frames(3, seed=10 + i) for i in range(4)]
    alone = [service.predict_frames(c)["keypoints"] for c in clips]
    sizes = []
    call = service.batcher.call
    service.batcher.call = lambda xs: (sizes.append(len(xs)), call(xs))[1]
    barrier = threading.Barrier(4)
    results = {}

    def client(i):
        barrier.wait()
        results[i] = service.predict_frames(clips[i])["keypoints"]

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    assert sorted(sizes) == [2, 2]
    assert [results[i] for i in range(4)] == alone


def test_too_long_clip_is_refused(clip_server):
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(clip_server, _frames(4, seed=7))
    assert err.value.code == 400
    assert "clip too long: 4 frames > clip length 3" in json.loads(err.value.read())["error"]
    with pytest.raises(urllib.error.HTTPError) as err:
        req = urllib.request.Request(
            f"http://127.0.0.1:{clip_server.server_address[1]}/predict_video",
            data=b'{"frames": []}', method="POST",
        )
        urllib.request.urlopen(req, timeout=30)
    assert err.value.code == 400


@pytest.mark.parametrize("stream", [False, True])
def test_make_server_on_cpu_builds_the_video_model(stream):
    argv = ["--device", "cpu", "--port", "0", "--dataset", "Penn_Action",
            "--model_arch", "uniposeLSTM", "--frame_memory", "4", "--batch", "3"]
    srv = serve.make_server(serve.parse_args(argv + (["--stream"] if stream else [])))
    try:
        model, meta = srv.service.model, srv.service.meta
        assert model.compute_dtype == torch.bfloat16 and not model.training
        assert model.num_classes == 13 and model.wasp.gap_batchnorm is False
        assert meta["kind"] == ("video_stream" if stream else "video")
        assert meta["input"] == [1 if stream else 3, 4, 368, 368, 3] and meta["device"] == "cpu"
    finally:
        srv.server_close()


def test_random_weights_serve_a_short_stream():
    """random_state_dict covers every tensor of the video model, and a
    one-frame stream is served."""
    model = build_model(CONFIG, layers=REDUCED)
    load_numpy_state_dict(model, random_state_dict(model, seed=8))
    service = serve.VideoService(model.eval(), size=SIZE, num_joints=13, clip_t=2, stream=True)
    got = service.predict_frames(_frames(1, seed=9))
    assert len(got["keypoints"]) == 1 and len(got["keypoints"][0]) == 13
