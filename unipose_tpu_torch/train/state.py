"""Train state: the model (parameters and BN buffers), the optimizer, the LR
scheduler, the update count and the dropout generator.

Counterpart of ``unipose_tpu/train/state.py``.  As there, the state is
complete: its ``state_dict`` restores training exactly, dropout masks
included.
"""

from __future__ import annotations

import dataclasses
import torch
import torch.nn as nn

from unipose_tpu_torch.core.config import ModelConfig, TrainConfig
from unipose_tpu_torch.models.layers import use_dropout_generator
from unipose_tpu_torch.models.unipose import init_model
from unipose_tpu_torch.train.optim import make_optimizer


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    generator: torch.Generator  # the model's dropout masks
    step: int = 0

    def state_dict(self) -> dict:
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "scheduler": self.scheduler.state_dict(),
            "generator": self.generator.get_state(),
            "step": self.step,
        }

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.generator.set_state(state["generator"])
        self.step = int(state["step"])


def create_train_state(model_config: ModelConfig, train_config: TrainConfig, seed: int, device=None):
    """Returns (model, optimizer, TrainState) on ``device`` (the card unless
    the caller passes ``device="cpu"``).

    The weights are the reference's init drawn from ``seed``; the dropout
    generator, on the model's device, is seeded with ``seed + 1``.  (The
    JAX signature's ``input_size`` shaped the dummy batch that traced its
    init; PyTorch builds the parameters without one.)
    """
    model = init_model(model_config, seed=seed, device=device).train()
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed + 1)
    use_dropout_generator(model, generator)
    optimizer, scheduler = make_optimizer(model.parameters(), train_config)
    state = TrainState(model, optimizer, scheduler, generator)
    return model, optimizer, state
