"""The port's video Trainer and warm start, on the CPU, on
Penn Action clips written to disk in the reference's layout
(penn_action_data.py:49-56), against the JAX package.

* Twin of tests/test_integration_video.py::test_video_trainer_end_to_end:
  both Trainers (reduced depth, 64x64, 2-frame clips) read the same root
  through their own loaders; with the JAX weights carried across and
  dropout off on both sides, their validations give the same mAP before
  training and their first train losses agree to 1e-5 relative on one
  batch; the port's Trainer then trains an epoch and validates per frame.
* ``warm_start_from_torch`` from a reference-format LSTM
  ``*.pth.tar`` loads every tensor of the port's LSTM.
The training CLI on such a root: tests/test_torch_video_cli.py.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import flax.linen
import jax

from torch_parity import perturb_bn, reduced_lstm_depth, two_threads  # noqa: F401
from unipose_tpu.compat.torch_export import export_state_dict
from unipose_tpu.core import config as jax_config
from unipose_tpu.models.unipose_lstm import UniPoseLSTM as JaxUniPoseLSTM
from unipose_tpu.train.trainer import Trainer as JaxTrainer
from unipose_tpu_torch.compat.from_jax import state_dict_from_jax
from unipose_tpu_torch.core.config import DATASETS, ModelConfig, TrainConfig
from unipose_tpu_torch.data.fixtures import write_penn_root
from unipose_tpu_torch.models.layers import Dropout
from unipose_tpu_torch.models.unipose import init_model
from unipose_tpu_torch.train import state as train_state
from unipose_tpu_torch.train.checkpoint import warm_start_from_torch
from unipose_tpu_torch.train.trainer import Trainer

REDUCED = (1, 1, 1, 1)
SIZE = 64
T = 2
pytestmark = pytest.mark.usefixtures("two_threads")


@pytest.fixture
def reduced_port_depth(monkeypatch):
    """The port's Trainer builds its model at reduced depth."""
    monkeypatch.setattr(train_state, "init_model", functools.partial(init_model, layers=REDUCED))


def _dropout_off(model):
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0


def test_video_trainer_end_to_end(tmp_path, monkeypatch, reduced_port_depth):
    root = write_penn_root(str(tmp_path / "penn"), "train", n_clips=2, n_frames=4, seed=0)
    write_penn_root(root, "val", n_clips=2, n_frames=4, seed=1)
    mc = ModelConfig(dataset="Penn_Action", num_classes=13, variant="lstm", frame_memory=T)
    tc = TrainConfig(batch_size=1, lr=1e-3, sigma=1.0, model_name="")
    spec = dataclasses.replace(DATASETS["Penn_Action"], input_size=SIZE)
    ours = Trainer(mc, tc, root, root, spec=spec, device="cpu", log_every=1)

    monkeypatch.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **kw: x)
    with reduced_lstm_depth(REDUCED):
        theirs = JaxTrainer(
            jax_config.ModelConfig(dataset="Penn_Action", num_classes=13, variant="lstm", frame_memory=T),
            jax_config.TrainConfig(batch_size=1, lr=1e-3, sigma=1.0, model_name=""),
            root, root, spec=dataclasses.replace(jax_config.DATASETS["Penn_Action"], input_size=SIZE),
        )
        variables = perturb_bn({"params": theirs.state.params, "batch_stats": theirs.state.batch_stats}, 3)
        theirs.state = theirs.state.replace(params=variables["params"], batch_stats=variables["batch_stats"])
        ours.model.load_state_dict(state_dict_from_jax(variables, variant="lstm"))
        _dropout_off(ours.model)

        # validation per frame, in dataset order: the same mAP
        assert ours.validation(0) == pytest.approx(theirs.validation(0), rel=1e-6, abs=0)
        # one train step on one disk batch: the same loss
        batch = next(iter(ours.train_loader))
        assert batch["frames"].shape == (1, T, SIZE, SIZE, 3) and batch["kpts"].shape == (1, T, 13, 3)
        loss = ours.train_step(ours.state, ours._device_batch(batch))["loss"].item()
        _, jmetrics = theirs.train_step(theirs.state, theirs._device_batch(batch))
    np.testing.assert_allclose(loss, float(jmetrics["loss"]), rtol=1e-5)

    epoch_loss = ours.training(0)
    assert np.isfinite(epoch_loss) and ours.state.step == 1 + len(ours.train_loader)
    assert 0.0 <= ours.validation(1) <= 1.0


def test_warm_start_from_a_reference_lstm_checkpoint(tmp_path, capsys, reduced_port_depth):
    """A reference-format UniPose-LSTM ``*.pth.tar`` (``{'state_dict':
    ...}``, DataParallel's ``module.`` prefix, per-gate ConvLSTM keys, the
    head at the top level), written from JAX variables by the JAX
    exporter: every tensor of the port's model loads, none is skipped, and
    each equals the JAX variable it came from."""
    with reduced_lstm_depth(REDUCED):
        model = JaxUniPoseLSTM(num_classes=13)
        variables = jax.jit(lambda k, f, c: model.init(k, f, c, train=False))(
            jax.random.PRNGKey(4), np.zeros((1, 2, SIZE, SIZE, 3), np.float32),
            np.zeros((1, 2, SIZE, SIZE, 1), np.float32))
    variables = perturb_bn(variables, 5)
    reference = export_state_dict(variables, variant="lstm")
    assert "lstm.conv_fh_lstm.weight" in reference and "conv5.bias" in reference
    path = str(tmp_path / "uniposeLSTM_best.pth.tar")
    torch.save({"state_dict": {f"module.{k}": torch.from_numpy(np.array(v)) for k, v in reference.items()}},
               path)

    _, _, state = train_state.create_train_state(
        ModelConfig(dataset="Penn_Action", num_classes=13, variant="lstm"), TrainConfig(), 0, "cpu")
    own = state.model.state_dict()
    assert warm_start_from_torch(state, path) is state
    assert f"warm start: loaded {len(own)} tensors, skipped 0" in capsys.readouterr().out
    assert len(reference) == len(own)
    want = state_dict_from_jax(variables, variant="lstm")
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, want[k].to(v.dtype)), k
