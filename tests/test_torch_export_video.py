"""The port's video artifacts (compat/export.py): the streaming pair
against the live model run in the same chunks, its full rollout and the
JAX model (the twin of tests/test_export.py::
test_export_video_stream_roundtrip), and a raw uint8 clip artifact against
the live model.

Tolerances: against the live model in the same chunks, 1e-6 max-norm
relative (the same ops in the same order); against a full rollout and
JAX, the parity bar, 1e-4.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_parity import (  # two_threads_for_the_module: an autouse fixture
    jax_variables,
    max_rel_err,
    reduced_lstm_depth,
    two_threads_for_the_module,
)
from unipose_tpu.models.unipose_lstm import UniPoseLSTM as JaxUniPoseLSTM
from unipose_tpu_torch.compat import export
from unipose_tpu_torch.core.config import ModelConfig
from unipose_tpu_torch.models.unipose import build_model, load_numpy_state_dict, random_state_dict

REDUCED = (1, 1, 1, 1)
SIZE = 64
VIDEO = ModelConfig(dataset="Penn_Action", num_classes=13, variant="lstm")


@pytest.fixture(scope="module")
def jax_video():
    """The port's UniPoseLSTM at reduced depth (seeded weights, BN
    perturbed) and the JAX model on the same weights."""
    model = build_model(VIDEO, layers=REDUCED)
    state = random_state_dict(model, seed=22)
    load_numpy_state_dict(model, state)
    with reduced_lstm_depth(REDUCED):
        jmodel = JaxUniPoseLSTM(num_classes=13)
        variables = jax_variables(jmodel, state, (1, 2, SIZE, SIZE, 3), (1, 2, SIZE, SIZE, 1), variant="lstm")
    return jmodel, variables, model.eval()


def test_export_video_stream_roundtrip(jax_video, tmp_path):
    """Twin of tests/test_export.py::test_export_video_stream_roundtrip: the
    init chunk, then the cont chunk with the carried state, equal the live
    model run in the same chunks (1e-6), its full rollout and the JAX
    model's (1e-4)."""
    jmodel, variables, model = jax_video
    b, t = 1, 2
    rng = np.random.RandomState(4)
    frames = rng.rand(b, 2 * t, SIZE, SIZE, 3).astype(np.float32)
    cm = rng.rand(b, 2 * t, SIZE, SIZE, 1).astype(np.float32)
    path = tmp_path / "stream.pt2"
    blob = export.export_video_stream(model, (b, t, SIZE, SIZE, 3), path=str(path))
    assert path.read_bytes() == blob and export.is_stream_artifact(blob)
    init, cont = export.load_video_stream(blob)
    assert [s[0] for s in export.output_specs(init)] == [(b, t, 8, 8, 14), (b, 8, 8, 15), (b, 8, 8, 15)]
    f, c = torch.from_numpy(frames), torch.from_numpy(cm)
    h1, cell, hide = init.module()(f[:, :t], c[:, :t])
    h2, _, _ = cont.module()(f[:, t:], c[:, t:], cell, hide)
    got = torch.cat([h1, h2], dim=1).numpy()
    with torch.no_grad():  # the live model run in the same two chunks, and in one
        nchw = f.permute(0, 1, 4, 2, 3), c.permute(0, 1, 4, 2, 3)
        l1, state = model(nchw[0][:, :t], nchw[1][:, :t])
        l2, _ = model(nchw[0][:, t:], nchw[1][:, t:], initial_state=state)
        full, _ = model(*nchw)
    chunked = torch.cat([l1, l2], dim=1).permute(0, 1, 3, 4, 2).numpy()
    assert max_rel_err(got, chunked) <= 1e-6
    assert max_rel_err(np.asarray(cell), state[0].permute(0, 2, 3, 1).numpy()) <= 1e-6
    # the chunks batch the x-gates otherwise than one rollout: f32 order only
    assert max_rel_err(got, full.permute(0, 1, 3, 4, 2).numpy()) < 1e-4
    with reduced_lstm_depth(REDUCED):
        want = jmodel.apply(variables, jnp.asarray(frames), jnp.asarray(cm), train=False)
    assert got.shape == want.shape == (b, 2 * t, SIZE // 8, SIZE // 8, 14)
    assert max_rel_err(got, np.asarray(want)) < 1e-4


def test_clip_artifact_matches_the_live_video_model(jax_video):
    model = jax_video[2]
    rng = np.random.RandomState(6)
    pixels = rng.randint(0, 256, (2, 3, SIZE, SIZE, 3)).astype(np.uint8)
    cm = rng.rand(2, 3, SIZE, SIZE, 1).astype(np.float32)
    blob = export.export_inference(model, (2, 3, SIZE, SIZE, 3), video=True, raw_uint8=True)
    got = export.load_inference(blob)(torch.from_numpy(pixels), torch.from_numpy(cm))
    with torch.no_grad():
        x = torch.from_numpy((pixels.astype(np.float32) - 128.0) / 256.0).permute(0, 1, 4, 2, 3)
        want, _ = model(x, torch.from_numpy(cm).permute(0, 1, 4, 2, 3))
    assert max_rel_err(got.numpy(), want.permute(0, 1, 3, 4, 2).numpy()) <= 1e-6
