"""The BBC long-video evaluation (BASELINE config 4) through the port,
composed as tests/test_integration_bbc.py composes it for the JAX package:
a BBC-format root -> ``BBCDataset(seq_len > 1)`` -> chunked streaming eval
(``eval/video.py::stream_video``) carrying the ConvLSTM state across more
than two chunks -> per-frame PCK (``eval/metrics.py::accuracy``).

The twin runs both packages on the same BBC root, the same weights (the
JAX variables, BN perturbed, through ``state_dict_from_jax(variant=
"lstm")``) and the same frames: twelve frames in three chunks of four, at
reduced depth and 64x64, small enough to run in Tier-1 (the JAX test is
``slow``).  Tolerances: heatmaps 1e-4 max-norm relative frame by frame;
the loaders' frames, keypoints and centers byte for byte; PCK exactly.
"""

import dataclasses

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
pytest.importorskip("scipy.io")

import jax
import jax.numpy as jnp
import torch

from torch_parity import max_rel_err, perturb_bn, reduced_lstm_depth, two_threads  # noqa: F401
from unipose_tpu.core.config import DATASETS as JAX_DATASETS
from unipose_tpu.data.bbc import BBCDataset as JaxBBCDataset
from unipose_tpu.eval.metrics import accuracy as jax_accuracy
from unipose_tpu.eval.video import stream_video as jax_stream_video
from unipose_tpu.models.unipose_lstm import UniPoseLSTM as JaxUniPoseLSTM
from unipose_tpu.train.steps import make_targets as jax_make_targets
from unipose_tpu_torch.compat.from_jax import state_dict_from_jax
from unipose_tpu_torch.core.config import DATASETS, ModelConfig
from unipose_tpu_torch.data.bbc import BBCDataset
from unipose_tpu_torch.data.fixtures import write_bbc_root
from unipose_tpu_torch.eval.metrics import accuracy
from unipose_tpu_torch.eval.video import stream_video
from unipose_tpu_torch.models.unipose import build_model
from unipose_tpu_torch.train.steps import make_targets

REDUCED = (1, 1, 1, 1)
SIZE = 64
T_TOTAL = 12
CHUNK = 4  # 12 frames -> 3 chunks: the first and two carried
pytestmark = pytest.mark.usefixtures("two_threads")


def shrink(sample, size):
    """The loader's 368x368 window at ``size`` (the tiny model's input):
    frames resized, keypoints and centers scaled, a clip batch of one."""
    scale = size / 368.0
    frames = np.stack([cv2.resize(f, (size, size)) for f in sample["frames"]]).astype(np.float32)[None]
    kpts = sample["kpts"].copy()[None]
    kpts[..., :2] *= scale
    centers = (sample["centers"] * scale).astype(np.float32)[None]
    return frames, kpts, centers


def test_bbc_stream_eval_matches_jax(tmp_path):
    root = write_bbc_root(str(tmp_path / "bbc"), T_TOTAL, seed=7)
    ds, jds = BBCDataset(root, 1.0, "Val", seq_len=T_TOTAL), JaxBBCDataset(root, 1.0, "Val", seq_len=T_TOTAL)
    assert len(ds) == len(jds) == 1
    sample, jsample = ds[0], jds[0]
    assert sample["frames"].shape == (T_TOTAL, 368, 368, 3)
    for k in ("frames", "kpts", "centers"):
        assert sample[k].tobytes() == jsample[k].tobytes(), k
    frames, kpts, centers = shrink(sample, SIZE)

    spec = dataclasses.replace(DATASETS["BBC"], input_size=SIZE)
    jspec = dataclasses.replace(JAX_DATASETS["BBC"], input_size=SIZE)
    with reduced_lstm_depth(REDUCED):
        jmodel = JaxUniPoseLSTM(num_classes=7)
        variables = jax.jit(lambda k, f, c: jmodel.init(k, f, c, train=False))(
            jax.random.PRNGKey(0), jnp.zeros((1, CHUNK, SIZE, SIZE, 3)), jnp.zeros((1, CHUNK, SIZE, SIZE, 1))
        )
        variables = perturb_bn(variables, 1)
        jheat = jax_stream_video(jmodel, variables["params"], variables["batch_stats"],
                                 frames, centers, jspec, chunk=CHUNK)
    model = build_model(ModelConfig(dataset="BBC", num_classes=7, variant="lstm", frame_memory=CHUNK),
                        layers=REDUCED)
    model.load_state_dict(state_dict_from_jax(variables, variant="lstm"))
    model = model.to(memory_format=torch.channels_last).eval()
    heat = stream_video(model, frames, centers, spec, chunk=CHUNK)

    h = SIZE // spec.stride
    assert heat.shape == (1, T_TOTAL, h, h, spec.num_channels) and np.isfinite(heat).all()
    for t in range(T_TOTAL):  # every chunk, the carried state's included
        assert max_rel_err(heat[:, t], jheat[:, t]) < 1e-4, t

    # per-frame PCK over the whole video (uniposeLSTM.py:140-217 semantics):
    # the same on both sides, frame by frame
    targets = make_targets(torch.from_numpy(kpts), spec).numpy()
    jtargets = np.asarray(jax_make_targets(jnp.asarray(kpts), jspec))
    np.testing.assert_allclose(targets, jtargets, rtol=0, atol=1e-6)
    for t in range(T_TOTAL):
        got = accuracy(heat[:, t], targets[:, t], 0.2, 0.5, "BBC", layout="NHWC")
        want = jax_accuracy(np.asarray(jheat)[:, t], jtargets[:, t], 0.2, 0.5, "BBC", layout="NHWC")
        np.testing.assert_array_equal(got[1], want[1])  # PCK, joint by joint
        np.testing.assert_array_equal(got[0], want[0])  # AP
        assert 0.0 <= got[1][0] <= 1.0
