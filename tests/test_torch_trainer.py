"""The port's Trainer on the synthetic pose set, on the CPU: its loaders
yield the JAX package's batches byte for byte, and a full-depth Trainer
learns, validates and writes a ``_best`` checkpoint that loads back."""

import dataclasses

import numpy as np
import torch

from unipose_tpu.data.synthetic import make_loaders as jax_make_loaders
from unipose_tpu_torch.core.config import DATASETS, ModelConfig, TrainConfig
from unipose_tpu_torch.data.synthetic import make_loaders
from unipose_tpu_torch.train.checkpoint import load_checkpoint
from unipose_tpu_torch.train.state import create_train_state
from unipose_tpu_torch.train.trainer import Trainer

SIZE = 64


def test_make_loaders_yields_the_jax_packages_batches():
    kw = dict(input_size=SIZE, train_samples=12, val_samples=5, batch_size=4, seed=3)
    ours, theirs = make_loaders("image", **kw), jax_make_loaders("image", **kw)
    for a, b in zip(ours[:2], theirs[:2]):
        a.set_epoch(1)
        b.set_epoch(1)
        got, want = list(a), list(b)
        assert len(got) == len(want) == len(a) and a.batch_size == b.batch_size
        for x, y in zip(got, want):
            assert sorted(x) == sorted(y) == ["image", "kpts"]
            for k in x:
                assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape
                assert x[k].tobytes() == y[k].tobytes()


def test_trainer_learns_validates_and_checkpoints(tmp_path):
    """Full depth, 64x64, batch 8, two epochs of 16 samples: the epoch loss
    falls, validation gives an mAP in [0, 1] (the last batch ragged and
    padded), and the best-mAP checkpoint loads back into a fresh state,
    equal key for key."""
    torch.manual_seed(0)
    spec = dataclasses.replace(DATASETS["LSP"], input_size=SIZE)
    tc = TrainConfig(lr=1e-3, model_name=str(tmp_path / "unipose"))
    loaders = make_loaders(
        "image", input_size=SIZE, train_samples=16, val_samples=10, batch_size=8
    )
    trainer = Trainer(ModelConfig(), tc, spec=spec, loaders=loaders, device="cpu", log_every=1)
    losses, maps = [], []
    for epoch in range(2):
        losses.append(trainer.training(epoch))
        maps.append(trainer.validation(epoch))
    trainer.finalize()
    assert np.isfinite(losses).all() and losses[1] < losses[0]
    assert all(0.0 <= m <= 1.0 for m in maps)
    assert trainer.state.step == 4 and trainer.is_best == max(maps)

    path = tmp_path / "unipose_best"
    assert path.exists() == (max(maps) > 0)
    trainer.is_best = -1.0
    trainer.validation(2)  # saves the current state
    _, _, fresh = create_train_state(ModelConfig(), tc, seed=1, device="cpu")
    load_checkpoint(fresh, str(path))
    want, got = trainer.state.state_dict(), fresh.state_dict()
    assert fresh.step == 4 and got["scheduler"] == want["scheduler"]
    assert torch.equal(got["generator"], want["generator"])
    assert sorted(got["model"]) == sorted(want["model"])
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    for k, v in want["optimizer"]["state"].items():
        for name, t in v.items():
            assert torch.equal(got["optimizer"]["state"][k][name], t), (k, name)
