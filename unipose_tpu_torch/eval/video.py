"""Streaming evaluation of videos of any length through the ConvLSTM.

Counterpart of ``unipose_tpu/eval/video.py``.  The reference can only roll
5-frame windows with a reset state (uniposeLSTM.py:106-128); here each
chunk's final (cell, hide) is carried into the next, so one recurrent
state spans the whole video with constant memory.  Frames are raw
(B, T, H, W, 3) pixels and heatmaps come back in the JAX layout,
(B, T, H/8, W/8, K+1).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from unipose_tpu_torch.core.config import DatasetSpec
from unipose_tpu_torch.train.steps import make_centermaps, preprocess_images


def make_stream_step(model: torch.nn.Module, spec: DatasetSpec) -> Callable:
    """``step(frames (B, T, H, W, 3) raw, centers (B, T, 2), state=None) ->
    (heat (B, T, h, w, K+1) f32, new state)`` on the model's device, in eval
    mode: the first chunk when ``state`` is None, a next chunk otherwise."""

    @torch.no_grad()
    def step(frames: torch.Tensor, centers: torch.Tensor, state: Optional[tuple] = None):
        model.eval()
        x = preprocess_images(frames).permute(0, 1, 4, 2, 3)
        cm = make_centermaps(centers, spec).permute(0, 1, 4, 2, 3)
        heat, state = model(x, cm, initial_state=state)
        return heat.permute(0, 1, 3, 4, 2), state

    return step


def stream_video(
    model: torch.nn.Module,
    frames: np.ndarray,
    centers: np.ndarray,
    spec: DatasetSpec,
    chunk: int = 5,
) -> np.ndarray:
    """A whole video (B, T, H, W, 3) through chunked streaming eval, one call
    to the card a chunk (right when frames arrive as they are decoded);
    returns (B, T, h, w, K+1) heatmaps.  T is padded to a multiple of
    ``chunk`` by repeating the last frame, and the pad's heatmaps dropped."""
    device = next(model.parameters()).device
    t_total = frames.shape[1]
    pad = (-t_total) % chunk
    if pad:
        frames = np.concatenate([frames, np.repeat(frames[:, -1:], pad, 1)], 1)
        centers = np.concatenate([centers, np.repeat(centers[:, -1:], pad, 1)], 1)
    step = make_stream_step(model, spec)
    outs, state = [], None
    for start in range(0, frames.shape[1], chunk):
        heat, state = step(
            torch.from_numpy(np.ascontiguousarray(frames[:, start : start + chunk])).to(device),
            torch.from_numpy(np.ascontiguousarray(centers[:, start : start + chunk])).to(device),
            state,
        )
        outs.append(heat.cpu().numpy())
    return np.concatenate(outs, axis=1)[:, :t_total]


def stream_video_scan(
    model: torch.nn.Module,
    frames: torch.Tensor,
    centers: torch.Tensor,
    spec: DatasetSpec,
    chunk: int = 5,
) -> torch.Tensor:
    """The twin of :func:`stream_video` for a video already in memory: the
    frames go to the card at once and the chunk heatmaps stay there, one
    (B, T, h, w, K+1) tensor on the model's device, fetched by the caller
    once.  Same chunking, padding and carried state."""
    device = next(model.parameters()).device
    frames = torch.as_tensor(frames).to(device)
    centers = torch.as_tensor(centers).to(device)
    t_total = frames.shape[1]
    pad = (-t_total) % chunk
    if pad:
        frames = torch.cat([frames, frames[:, -1:].repeat_interleave(pad, 1)], 1)
        centers = torch.cat([centers, centers[:, -1:].repeat_interleave(pad, 1)], 1)
    step = make_stream_step(model, spec)
    heats, state = [], None
    for start in range(0, frames.shape[1], chunk):
        heat, state = step(frames[:, start : start + chunk], centers[:, start : start + chunk], state)
        heats.append(heat)
    return torch.cat(heats, dim=1)[:, :t_total]
