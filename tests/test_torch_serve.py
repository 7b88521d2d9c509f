"""The port's image server: micro-batching, /predict over HTTP against the
JAX package's keypoint decode, /healthz, and reference-checkpoint loading."""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from unipose_tpu.cli.serve import _argmax_kpts as jax_argmax_kpts
from unipose_tpu_torch.cli import serve
from unipose_tpu_torch.compat.torch_convert import (
    load_state_dict_intersection,
    load_torch_checkpoint,
)
from unipose_tpu_torch.core.config import ModelConfig
from unipose_tpu_torch.models.unipose import (
    init_model,
    load_numpy_state_dict,
    random_state_dict,
)
from unipose_tpu_torch.train.steps import preprocess_images

REDUCED = (1, 1, 1, 1)


def _concurrent_infer(batcher, values, timeout=30.0):
    """N client threads through batcher.infer; (results, errors) by index."""
    results, errors = {}, {}

    def client(i, v):
        try:
            results[i] = batcher.infer(np.full((2, 2, 3), v, np.float32))
        except Exception as e:  # noqa: BLE001
            errors[i] = e

    threads = [threading.Thread(target=client, args=(i, v)) for i, v in enumerate(values)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
        assert not t.is_alive(), "client thread hung"
    return results, errors


def test_microbatcher_coalesces_concurrent_clients():
    """N concurrent requests with N == batch make exactly one call."""
    calls = []
    barrier = threading.Barrier(8 + 1)

    def call(xs):
        calls.append(np.asarray(xs).copy())
        return xs * 2.0

    batcher = serve.MicroBatcher(call, batch=8, wait_ms=200.0)
    results = {}

    def client(i):
        barrier.wait()
        results[i] = batcher.infer(np.full((2, 2, 3), float(i), np.float32))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    barrier.wait()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    assert len(calls) == 1, f"expected one coalesced call, got {len(calls)}"
    assert calls[0].shape[0] == 8
    for i in range(8):
        np.testing.assert_array_equal(results[i], np.full((2, 2, 3), 2.0 * i))


def test_microbatcher_failure_poisons_only_its_batch():
    state = {"n": 0}

    def call(xs):
        state["n"] += 1
        if state["n"] == 1:
            raise RuntimeError("injected device failure")
        return xs + 1.0

    batcher = serve.MicroBatcher(call, batch=4, wait_ms=50.0)
    results, errors = _concurrent_infer(batcher, [1.0, 2.0, 3.0, 4.0])
    assert len(errors) == 4 and not results
    assert all("injected device failure" in str(e) for e in errors.values())
    results, errors = _concurrent_infer(batcher, [5.0, 6.0, 7.0, 8.0])
    assert not errors and len(results) == 4
    for i, v in enumerate([5.0, 6.0, 7.0, 8.0]):
        np.testing.assert_array_equal(results[i], np.full((2, 2, 3), v + 1.0))


def test_microbatcher_runs_the_real_batch_size():
    """32 clients against batch 4: every request served once, and no call
    carries padding slots (calls sum to exactly 32 rows)."""
    calls = []

    def call(xs):
        calls.append(xs.shape[0])
        return xs * 3.0

    batcher = serve.MicroBatcher(call, batch=4, wait_ms=5.0)
    values = [float(i) for i in range(32)]
    results, errors = _concurrent_infer(batcher, values)
    assert not errors and len(results) == 32
    for i, v in enumerate(values):
        np.testing.assert_array_equal(results[i], np.full((2, 2, 3), v * 3.0))
    assert sum(calls) == 32 and max(calls) <= 4


def test_argmax_kpts_matches_jax():
    rng = np.random.RandomState(0)
    heat = rng.rand(46, 46, 15).astype(np.float32)
    heat[3, 7, 2] = heat[9, 1, 2] = 5.0  # a tie: the first occurrence wins
    assert serve._argmax_kpts(heat, 14, 640, 480) == jax_argmax_kpts(heat, 14, 640, 480)


@pytest.fixture(scope="module")
def server():
    """A reduced-depth model behind the HTTP server on an ephemeral port."""
    model = init_model(ModelConfig(), seed=0, device="cpu", layers=REDUCED)
    load_numpy_state_dict(model, random_state_dict(model, seed=1))
    service = serve.ImageService(model, size=64, num_joints=14, batch=2, wait_ms=5.0)
    srv = serve.http_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv
    srv.shutdown()
    srv.server_close()
    thread.join(10)


def _url(srv, path):
    return f"http://127.0.0.1:{srv.server_address[1]}{path}"


def test_healthz(server):
    with urllib.request.urlopen(_url(server, "/healthz"), timeout=30) as r:
        meta = json.loads(r.read())
    assert meta["status"] == "ok" and meta["kind"] == "image"
    assert meta["num_joints"] == 14 and meta["input"] == [2, 64, 64, 3]


def test_predict_over_http_matches_jax_decode(server):
    """A cv2-encoded image through /predict gives the keypoints that the
    JAX package's decode gives on the same model's heatmaps."""
    import cv2

    img = np.random.RandomState(2).randint(0, 256, (90, 120, 3)).astype(np.uint8)
    ok, buf = cv2.imencode(".png", img)
    assert ok
    req = urllib.request.Request(_url(server, "/predict"), data=buf.tobytes(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        got = json.loads(r.read())

    x = torch.from_numpy(cv2.resize(img, (64, 64)))[None]
    with torch.no_grad():
        heat = server.service.model(preprocess_images(x).permute(0, 3, 1, 2))
    heat = heat.permute(0, 2, 3, 1)[0].numpy()
    assert got["keypoints"] == jax_argmax_kpts(heat, 14, 120, 90)
    assert got["ms"] > 0


def test_predict_rejects_bad_bodies(server):
    req = urllib.request.Request(_url(server, "/predict"), data=b"not an image", method="POST")
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(req, timeout=30)
    assert err.value.code == 400
    with pytest.raises(ValueError):
        server.service.predict_image(np.zeros((64, 64), np.uint8))


def test_reference_checkpoint_loads_by_key_intersection(tmp_path):
    """The reference's {'state_dict': ...} wrapper with DataParallel's
    'module.' prefix; the dead decoder.conv2 key and a wrong-shape key are
    skipped, every model key is loaded."""
    src = init_model(ModelConfig(), seed=0, device="cpu", layers=REDUCED)
    state = {k: torch.from_numpy(v) for k, v in random_state_dict(src, seed=3).items()}
    blob = {f"module.{k}": v for k, v in state.items()}
    blob["module.decoder.conv2.weight"] = torch.zeros(48, 256, 1, 1)
    blob["module.decoder.bn1.weight"] = torch.zeros(7)
    path = tmp_path / "ref.pth.tar"
    torch.save({"state_dict": blob, "epoch": 3}, path)

    loaded = load_torch_checkpoint(str(path))
    assert "decoder.conv2.weight" in loaded
    dst = init_model(ModelConfig(), seed=1, device="cpu", layers=REDUCED)
    report = load_state_dict_intersection(dst, loaded)
    assert sorted(report["skipped"]) == ["decoder.bn1.weight", "decoder.conv2.weight"]
    assert len(report["loaded"]) == len(state) - 1
    for k, v in state.items():
        if k != "decoder.bn1.weight":
            torch.testing.assert_close(dst.state_dict()[k], v, rtol=0, atol=0)


def test_make_server_on_cpu_serves_healthz():
    args = serve.parse_args(["--device", "cpu", "--port", "0", "--batch", "3"])
    srv = serve.make_server(args)
    try:
        model = srv.service.model
        assert model.compute_dtype == torch.bfloat16 and not model.training
        assert srv.service.meta["input"] == [3, 368, 368, 3]
        assert srv.service.meta["device"] == "cpu"
    finally:
        srv.server_close()
