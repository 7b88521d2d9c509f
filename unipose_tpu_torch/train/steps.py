"""Train, validation and eval steps with device-side preprocessing.

Counterpart of ``unipose_tpu/train/steps.py``.  Raw images (B, H, W, 3)
and keypoints (B, K, 3), or for the video variant (``video=True``) raw
frames (B, T, H, W, 3), keypoints (B, T, K, 3) and clip centers (B, T, 2),
go to the device; normalisation, (x - 128) / 256
(utils/lsp_lspet_data.py:242-243), the centermaps and the Gaussian targets
are computed there.  Loss: MSE over every heatmap element (unipose.py:70,
117); the video loss sums the per-frame MSEs (uniposeLSTM.py:124-128),
``T * mean``.  Heatmaps are compared in the JAX layout, NHWC: the model's
NCHW output is channels-last in memory, so its NHWC view costs no copy.  No
step reads a value back to the host.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

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


def forward_video_nhwc(
    model: nn.Module, frames: torch.Tensor, centers: torch.Tensor, spec: DatasetSpec,
    initial_state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
):
    """Raw (B, T, H, W, 3) frames and (B, T, 2) centers -> the LSTM model's
    (B, T, H/8, W/8, K+1) f32 heatmaps (a free view of its channels-last
    output) and its final (cell, hide).  The one place where frames and
    centermaps are laid out for the model: the steps and the streaming
    evaluation (``eval/video.py``) all call it."""
    x = preprocess_images(frames).permute(0, 1, 4, 2, 3)
    cm = make_centermaps(centers, spec).permute(0, 1, 4, 2, 3)
    heat, state = model(x, cm, initial_state=initial_state)
    return heat.permute(0, 1, 3, 4, 2), state


def _flat(a: torch.Tensor) -> torch.Tensor:
    """(B, T, ...) -> (B*T, ...), frames in clip order."""
    return a.reshape((-1,) + tuple(a.shape[2:]))


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
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    spec: DatasetSpec,
    *,
    video: bool = False,
    fused_loss: bool = False,
    time_shards: int = 1,
) -> Callable:
    """``step(state, batch) -> {"loss": 0-dim device tensor}``: one update
    of ``state`` (a ``TrainState`` over ``model`` and ``optimizer``) in
    place.  ``batch``: device tensors ``image`` (B, H, W, 3) and ``kpts``
    (B, K, 3); with ``video``, ``frames`` (B, T, H, W, 3), ``kpts``
    (B, T, K, 3) and ``centers`` (B, T, 2).

    ``fused_loss``: the ``heatmap_mse`` kernels, which build the targets
    inside the loss and its gradient, in place of materialised targets and
    ``mse`` (the same function).  The video loss is ``heatmap_mse`` over
    the B*T frames times T, the sum of the per-frame means.

    ``model`` may be the model under ``DistributedDataParallel`` (the
    ``Trainer`` across ranks): each rank's loss is then its rows' mean,
    and DDP's average of the ranks' gradients makes the update the
    global batch's.  ``time_shards``: the clips' frames are split over
    this many ranks (time parallelism, run under ``cp.under_mesh``), so a
    rank's ``frames`` hold T / time_shards frames of each clip, and its
    loss, the mean over them, is multiplied by the clip's T.
    """

    def step(state, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.train()
        kpts = batch["kpts"]
        if video:
            out, _ = forward_video_nhwc(model, batch["frames"], batch["centers"], spec)
            t = out.shape[1] * time_shards
            out, kpts = _flat(out), _flat(kpts)
        else:
            out, t = _forward_nhwc(model, batch["image"]), 1
        if fused_loss:
            # the kernels read the (B[*T], K, 3) rows in place: no copy of
            # the keypoints; the NHWC view of the channels-last heatmaps is
            # contiguous already
            loss = heatmap_mse(out.contiguous(), kpts[..., :2], spec.stride, spec.sigma)
        else:
            loss = mse(out, make_targets(kpts, spec))
        if video:
            loss = loss * t
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        state.scheduler.step()
        state.step += 1
        return {"loss": loss.detach()}

    return step


def _eval_forward(model, spec, batch, video: bool):
    """Eval-mode heatmaps and rendered targets, NHWC, and the MSE (times T
    for a clip)."""
    if video:
        out, _ = forward_video_nhwc(model, batch["frames"], batch["centers"], spec)
    else:
        out = _forward_nhwc(model, batch["image"])
    targets = make_targets(batch["kpts"], spec)
    loss = mse(out, targets)
    return out, targets, loss * out.shape[1] if video else loss


def make_val_step(model: nn.Module, spec: DatasetSpec, *, video: bool = False) -> Callable:
    """``step(batch) -> (pred (B, [T,] K+1, 2), target (B, [T,] K+1, 2),
    loss)``: eval-mode forward and MSE, with the argmax of predictions and
    targets taken on the device (over the B*T frames of a clip batch), so
    that only coordinates cross to the host."""

    def step(batch):
        with _eval_mode(model):
            out, targets, loss = _eval_forward(model, spec, batch, video)
            pred, _ = get_max_preds_device(_flat(out) if video else out)
            tgt, _ = get_max_preds_device(_flat(targets) if video else targets)
        if video:  # back to (B, T, K+1, 2)
            pred, tgt = (a.reshape(out.shape[:2] + a.shape[1:]) for a in (pred, tgt))
        return pred, tgt, loss

    return step


def make_eval_step(model: nn.Module, spec: DatasetSpec, *, video: bool = False) -> Callable:
    """``step(batch) -> (heatmaps, targets, loss)``: eval-mode forward; f32
    heatmaps and rendered targets, both NHWC ((B, T, ...) for a clip), and
    the batch's MSE (times T for a clip)."""

    def step(batch):
        with _eval_mode(model):
            return _eval_forward(model, spec, batch, video)

    return step
