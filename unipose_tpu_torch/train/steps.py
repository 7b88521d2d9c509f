"""Train, validation and eval steps with device-side preprocessing.

Counterpart of ``unipose_tpu/train/steps.py`` (image branch).  Raw images
(B, H, W, 3) and keypoints (B, K, 3) go to the device; normalisation,
(x - 128) / 256 (utils/lsp_lspet_data.py:242-243), and the Gaussian targets
are computed there.  Loss: MSE over every heatmap element (unipose.py:70,
117).  Heatmaps are compared in the JAX layout, NHWC: the model's NCHW
output is channels-last in memory, so its NHWC view costs no copy.  No step
reads a value back to the host.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict

import torch
import torch.nn as nn

from unipose_tpu_torch.core.config import DatasetSpec
from unipose_tpu_torch.eval.metrics import get_max_preds_device
from unipose_tpu_torch.ops.heatmap import gaussian_heatmaps, render_targets
from unipose_tpu_torch.ops.kernels.heatmap_mse import heatmap_mse

MEAN = 128.0
STD = 256.0


def preprocess_images(images: torch.Tensor) -> torch.Tensor:
    """(x - 128) / 256 in f32, any shape (BGR channel-last as decoded)."""
    return (images.float() - MEAN) / STD


def make_targets(kpts: torch.Tensor, spec: DatasetSpec) -> torch.Tensor:
    """(..., K, 3) keypoints -> (..., H/stride, W/stride, K+1) heatmaps."""
    size = spec.input_size
    return render_targets(kpts[..., :2], size, size, spec.stride, spec.sigma)


def make_centermaps(centers: torch.Tensor, spec: DatasetSpec) -> torch.Tensor:
    """(..., 2) centers -> (..., H, W, 1) full-resolution sigma-3 centermaps
    (utils/lsp_lspet_data.py:236-240, penn_action_data.py:129-133)."""
    size = spec.input_size
    return gaussian_heatmaps(centers, (size, size), 3.0)[..., None]


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred - target.to(pred.dtype)))


def _forward_nhwc(model: nn.Module, images: torch.Tensor) -> torch.Tensor:
    """Raw (B, H, W, 3) images -> the model's (B, H/8, W/8, K+1) f32 heatmaps."""
    return model(preprocess_images(images).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


@contextlib.contextmanager
def _eval_mode(model: nn.Module):
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            yield
    finally:
        model.train(was_training)


def make_train_step(
    model: nn.Module, optimizer: torch.optim.Optimizer, spec: DatasetSpec, *, fused_loss: bool = False
) -> Callable:
    """``step(state, batch) -> {"loss": 0-dim device tensor}``: one update
    of ``state`` (a ``TrainState`` over ``model`` and ``optimizer``) in
    place.  ``batch``: device tensors ``image`` (B, H, W, 3) and ``kpts``
    (B, K, 3).

    ``fused_loss``: the ``heatmap_mse`` kernels, which build the targets
    inside the loss and its gradient, in place of materialised targets and
    ``mse`` (the same function).
    """

    def step(state, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.train()
        out = _forward_nhwc(model, batch["image"])
        kpts = batch["kpts"]
        if fused_loss:
            loss = heatmap_mse(
                out.contiguous(), kpts[..., :2].contiguous(), spec.stride, spec.sigma
            )
        else:
            loss = mse(out, make_targets(kpts, spec))
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        state.scheduler.step()
        state.step += 1
        return {"loss": loss.detach()}

    return step


def make_val_step(model: nn.Module, spec: DatasetSpec) -> Callable:
    """``step(batch) -> (pred (B, K+1, 2), target (B, K+1, 2), loss)``:
    eval-mode forward and MSE, with the argmax of predictions and targets
    taken on the device, so that only coordinates cross to the host."""

    def step(batch):
        with _eval_mode(model):
            out = _forward_nhwc(model, batch["image"])
            targets = make_targets(batch["kpts"], spec)
            loss = mse(out, targets)
            pred, _ = get_max_preds_device(out)
            tgt, _ = get_max_preds_device(targets)
        return pred, tgt, loss

    return step


def make_eval_step(model: nn.Module, spec: DatasetSpec) -> Callable:
    """``step(batch) -> (heatmaps, targets, loss)``: eval-mode forward; f32
    heatmaps and rendered targets, both NHWC, and the batch's MSE."""

    def step(batch):
        with _eval_mode(model):
            out = _forward_nhwc(model, batch["image"])
            targets = make_targets(batch["kpts"], spec)
            loss = mse(out, targets)
        return out, targets, loss

    return step
