"""The model's weight caches follow training: an eval forward after a train
step uses the updated weights and BN statistics.

Two caches are keyed on tensor version counters: the cast weight of a bf16
``Conv2d`` (models/layers.py) and WASP's folded weights (models/wasp.py).
``optimizer.step()`` updates the weights in place and train-mode BN its
running statistics; a cache that missed that would serve the old weights
without an error.  Each case runs an eval forward, one train step and an
eval forward again, and holds the last against a freshly built model that
loads the post-step ``state_dict``.  bf16 compute, so the conv cast cache is
in play.  This file imports no jax: run it on the card with

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_caches.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from unipose_tpu_torch.core.config import DATASETS, ModelConfig, TrainConfig
from unipose_tpu_torch.models.layers import use_dropout_generator
from unipose_tpu_torch.models.unipose import build_model, load_numpy_state_dict, random_state_dict
from unipose_tpu_torch.train.optim import make_optimizer
from unipose_tpu_torch.train.state import TrainState
from unipose_tpu_torch.train.steps import make_train_step, preprocess_images

REDUCED = (1, 1, 1, 1)
SIZE = 32
CONFIG = ModelConfig(compute_dtype=torch.bfloat16)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _model(device):
    model = build_model(CONFIG, layers=REDUCED)
    load_numpy_state_dict(model, random_state_dict(model, seed=41))
    return model.to(device, memory_format=torch.channels_last)


def _eval_forward(model, images):
    model.eval()
    with torch.no_grad():
        return model(preprocess_images(images).permute(0, 3, 1, 2))


def _check_eval_follows_a_train_step(device, adam_kwargs):
    rng = np.random.RandomState(42)
    batch = {
        "image": torch.from_numpy((rng.rand(2, SIZE, SIZE, 3) * 255).astype(np.float32)).to(device),
        "kpts": torch.from_numpy(
            np.concatenate([rng.rand(2, 14, 2) * SIZE, np.ones((2, 14, 1))], -1).astype(np.float32)
        ).to(device),
    }
    model = _model(device)
    before = _eval_forward(model, batch["image"])  # fills both caches
    assert model.wasp._folded is not None
    assert model.backbone.conv1._cast is not None

    gen = torch.Generator(device=device).manual_seed(43)
    use_dropout_generator(model, gen)
    if adam_kwargs is None:  # the port's own optimizer and schedule
        optimizer, scheduler = make_optimizer(model.parameters(), TrainConfig(lr=1e-2))
    else:
        optimizer = torch.optim.Adam(model.parameters(), lr=1e-2, **adam_kwargs)
        scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lambda n: 1.0)
    state = TrainState(model, optimizer, scheduler, gen)
    spec = dataclasses.replace(DATASETS["LSP"], input_size=SIZE)
    make_train_step(model, optimizer, spec, fused_loss=True)(state, batch)

    after = _eval_forward(model, batch["image"])
    fresh = build_model(CONFIG, layers=REDUCED)
    fresh.load_state_dict(model.state_dict())
    fresh = fresh.to(device, memory_format=torch.channels_last)
    want = _eval_forward(fresh, batch["image"])
    assert not torch.equal(after, before)  # the step changed the model
    torch.testing.assert_close(after, want, rtol=0, atol=0)


# The port's optimizer (train/optim.py::make_optimizer: Adam with torch's
# default implementation, foreach on the card) and both unfused forms
# explicitly.  A fused Adam moves no version counter: the port does not use it.
ADAM_VARIANTS = [None, {"foreach": False}, {"foreach": True}]
ADAM_IDS = ["make_optimizer", "for_loop", "foreach"]


@pytest.mark.parametrize("adam_kwargs", ADAM_VARIANTS, ids=ADAM_IDS)
def test_eval_after_a_train_step_uses_the_new_weights(adam_kwargs):
    _check_eval_follows_a_train_step(torch.device("cpu"), adam_kwargs)


@pytest.mark.cuda
@pytest.mark.parametrize("adam_kwargs", ADAM_VARIANTS, ids=ADAM_IDS)
def test_eval_after_a_train_step_uses_the_new_weights_on_the_card(cuda, adam_kwargs):
    _check_eval_follows_a_train_step(cuda, adam_kwargs)
