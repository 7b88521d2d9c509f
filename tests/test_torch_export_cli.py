"""The port's export CLI and ``cli/serve.py --artifact``: twins of
tests/test_cli.py::test_export_cli_* and of tests/test_serve.py's artifact
tests for images (predict, micro-batching to the baked batch, the int8 and
raw uint8 artifacts, a failing call that reaches only its batch), and the
flags that are refused.  The video artifacts' server:
tests/test_torch_serve_artifact_video.py.

The CLIs build the model through ``train/state.py``'s ``init_model``,
patched to cut the backbone's depth (``torch_parity.export_artifact``; the
int8 front end needs layer1 and layer2 whole).  Keypoints are checked against the JAX server's decode
(``unipose_tpu/cli/serve.py::_argmax_kpts``) of the artifact's heatmaps.
"""

import functools

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from torch_parity import (  # two_threads_for_the_module: an autouse fixture; noqa: E402
    SIZE,
    artifact_server,
    export_artifact,
    in_frame,
    jpeg,
    post_concurrently,
    serve_args,
    two_threads_for_the_module,
)
from unipose_tpu.cli.serve import _argmax_kpts as jax_argmax_kpts  # noqa: E402
from unipose_tpu_torch.cli import export as export_cli  # noqa: E402
from unipose_tpu_torch.cli import serve  # noqa: E402
from unipose_tpu_torch.compat.export import input_specs, load_exported, output_specs  # noqa: E402
from unipose_tpu_torch.core.config import ModelConfig, TrainConfig  # noqa: E402
from unipose_tpu_torch.models.unipose import init_model  # noqa: E402
from unipose_tpu_torch.train import state as train_state  # noqa: E402
from unipose_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402

REDUCED = (1, 1, 1, 1)
INT8_DEPTH = (3, 4, 1, 1)


@pytest.fixture(scope="module")
def image_artifact(tmp_path_factory):
    return export_artifact(tmp_path_factory, "model.pt2", "--dataset", "LSP")


def test_export_cli_roundtrip(image_artifact):
    """Twin of tests/test_cli.py::test_export_cli_roundtrip: the artifact
    says its own geometry and joint count."""
    ep = load_exported(open(image_artifact, "rb").read())
    assert input_specs(ep) == [((1, SIZE, SIZE, 3), torch.float32)]
    assert output_specs(ep)[0][0][-1] == 15  # 14 joints + background


def test_export_cli_from_checkpoint_dir(tmp_path, capsys):
    """Twin of tests/test_cli.py::test_export_cli_from_checkpoint_dir: the
    newest step of a cli/train.py checkpoint directory is baked in."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_state, "init_model", functools.partial(init_model, layers=REDUCED))
        model, _, state = train_state.create_train_state(ModelConfig(), TrainConfig(), seed=3, device="cpu")
    state.step = 5
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(5, state)
    mgr.close()
    out = tmp_path / "model.pt2"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_state, "init_model", functools.partial(init_model, layers=REDUCED))
        export_cli.main(["--dataset", "LSP", "--out", str(out), "--size", str(SIZE), "--device", "cpu",
                         "--checkpoint_dir", str(tmp_path / "ckpt")])
    assert "restored step 5" in capsys.readouterr().out
    x = torch.from_numpy(np.random.RandomState(0).rand(1, SIZE, SIZE, 3).astype(np.float32))
    with torch.no_grad():  # the seed-3 weights, not the CLI's seed 0
        want = model.eval()(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    got = load_exported(out.read_bytes()).module()(x)
    assert torch.equal(got, want)
    with pytest.raises(SystemExit, match="no checkpoint"):
        export_cli.main(["--out", str(out), "--size", str(SIZE), "--device", "cpu",
                         "--checkpoint_dir", str(tmp_path / "empty")])


def test_stream_with_int8_frontend_is_refused(tmp_path):
    with pytest.raises(SystemExit, match="--stream with --int8_frontend"):
        export_cli.main(["--out", str(tmp_path / "x.pt2"), "--model_arch", "uniposeLSTM",
                         "--stream", "--int8_frontend", "--device", "cpu"])
    with pytest.raises(SystemExit, match="requires --model_arch uniposeLSTM"):
        export_cli.main(["--out", str(tmp_path / "x.pt2"), "--stream", "--device", "cpu"])


def test_serve_predict(image_artifact, artifact_server):
    """Twin of tests/test_serve.py::test_serve_predict: /healthz from the
    artifact, keypoints in the image's pixels (the JAX decode of the
    artifact's heatmaps), a bad body refused, the server alive after."""
    srv = artifact_server(serve_args(image_artifact))
    health = srv.get()
    assert health["status"] == "ok" and health["kind"] == "image" and health["num_joints"] == 14
    assert health["input"] == [1, SIZE, SIZE, 3] and health["input_dtype"] == "float32"
    assert health["batch"] == 1 and health["device"] == "cpu" and health["artifact_bytes"] > 1000
    body = jpeg(0)
    status, out = srv.post("/predict", body)
    assert status == 200, out
    img = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
    x = (cv2.resize(img, (SIZE, SIZE)).astype(np.float32) - 128.0) / 256.0
    heat = srv.service.program(torch.from_numpy(x[None])).numpy()[0]
    assert out["keypoints"] == jax_argmax_kpts(heat, 14, 120, 90)
    assert in_frame(out["keypoints"], 120, 90)
    status, out = srv.post("/predict", b"not an image")
    assert status == 400
    assert srv.get()["status"] == "ok"


def test_num_joints_above_the_artifacts_is_refused(image_artifact):
    with pytest.raises(SystemExit, match="exceeds the artifact's 14"):
        serve.make_server(serve_args(image_artifact, num_joints=20))
    srv = serve.make_server(serve_args(image_artifact, num_joints=5))
    try:
        assert srv.service.meta["num_joints"] == 5
    finally:
        srv.server_close()


@pytest.fixture(scope="module")
def batched_u8_artifact(tmp_path_factory):
    return export_artifact(tmp_path_factory, "model_b4_u8.pt2", "--dataset", "LSP", "--batch", "4", "--raw_uint8")


def test_serve_micro_batching_raw_uint8(batched_u8_artifact, artifact_server, monkeypatch):
    """Twins of tests/test_serve.py::test_serve_micro_batching and
    ::test_raw_uint8_artifact_roundtrip: concurrent requests share calls of
    the batch-4 artifact, a lone one is padded to it, and the uint8 wire
    format is read from the artifact."""
    srv = artifact_server(serve_args(batched_u8_artifact, batch_wait_ms=100.0))
    health = srv.get()
    assert health["batch"] == 4 and health["input_dtype"] == "uint8"
    calls = []
    program = srv.service.program
    monkeypatch.setattr(srv.service, "program", lambda x: calls.append(tuple(x.shape)) or program(x))
    bodies = [jpeg(s, (70, 90, 3)) for s in range(5)]
    results = post_concurrently(srv, "/predict", bodies[:4])
    for status, out in results:
        assert status == 200, out
        assert len(out["keypoints"]) == 14 and in_frame(out["keypoints"], 90, 70)
    status, out = srv.post("/predict", bodies[4])  # alone: padded to the baked batch
    assert status == 200 and len(out["keypoints"]) == 14
    assert all(shape == (4, SIZE, SIZE, 3) for shape in calls) and len(calls) < 5


def test_a_failing_call_reaches_only_its_batch(batched_u8_artifact, artifact_server, monkeypatch):
    srv = artifact_server(serve_args(batched_u8_artifact, batch_wait_ms=100.0))
    program, state = srv.service.program, {"n": 0}

    def flaky(x):
        state["n"] += 1
        if state["n"] == 1:
            raise RuntimeError("injected device failure")
        return program(x)

    monkeypatch.setattr(srv.service, "program", flaky)
    bodies = [jpeg(s) for s in range(4)]
    results = post_concurrently(srv, "/predict", bodies)
    failed = [out for status, out in results if status == 400]
    assert failed and all("injected device failure" in out["error"] for out in failed)
    assert all(status == 200 for status, _ in post_concurrently(srv, "/predict", bodies))


def test_serve_int8_artifact(tmp_path_factory, artifact_server):
    """Twin of tests/test_serve.py::test_serve_int8_artifact: an
    --int8_frontend artifact from the CLI serves as any image artifact."""
    path = export_artifact(tmp_path_factory, "int8.pt2", "--dataset", "LSP", "--int8_frontend", layers=INT8_DEPTH)
    ep = load_exported(open(path, "rb").read())
    assert sum(str(n.target).startswith("unipose.conv_i8_requant") for n in ep.graph.nodes) == 24
    srv = artifact_server(serve_args(path))
    health = srv.get()
    assert health["num_joints"] == 14 and health["input"] == [1, SIZE, SIZE, 3]
    status, out = srv.post("/predict", jpeg(3, (80, 100, 3)))
    assert status == 200, out
    assert len(out["keypoints"]) == 14 and in_frame(out["keypoints"], 100, 80)


def test_entry_points_need_a_card_unless_told_cpu(image_artifact, tmp_path, monkeypatch):
    """cli/export.py and cli/serve.py --artifact run on the card unless
    --device cpu is given: with no card they raise, and do not fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_cli.main(["--out", str(tmp_path / "x.pt2")])
    args = serve.parse_args(["--artifact", image_artifact, "--port", "0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.make_server(args)
