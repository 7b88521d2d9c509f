"""Batched Gaussian heatmap targets, on whatever device the keypoints are.

Counterpart of ``unipose_tpu/ops/heatmap.py``, channel-last as there:
  * joint centers are ``int(kpt) / stride``: truncation toward zero, then
    float division (Reference: utils/lsp_lspet_data.py:227-228);
  * the Gaussian is ``exp(-D2 / 2 / sigma / sigma)`` on an integer grid
    (Reference: utils/lsp_lspet_data.py:65-68);
  * values are clamped: ``> 1 -> 1``, then ``< 0.0099 -> 0``
    (Reference: utils/lsp_lspet_data.py:230-231);
  * channel 0 is the background, ``1 - max(joint channels)``
    (Reference: utils/lsp_lspet_data.py:234).
"""

from __future__ import annotations

import torch


def gaussian_kernel(size_w: int, size_h: int, center_x, center_y, sigma) -> torch.Tensor:
    """The reference's ``guassian_kernel`` (utils/lsp_lspet_data.py:65-68):
    (size_h, size_w) f32, unclamped."""
    gridy = torch.arange(size_h, dtype=torch.float32)[:, None]
    gridx = torch.arange(size_w, dtype=torch.float32)[None, :]
    d2 = (gridx - center_x) ** 2 + (gridy - center_y) ** 2
    return torch.exp(-d2 / 2.0 / sigma / sigma)


def gaussian_heatmaps(centers, size_hw, sigma) -> torch.Tensor:
    """Clamped Gaussians at ``centers`` (..., 2) as (x, y) -> (..., H, W)
    f32, over every leading dim at once (batch, time, joints)."""
    h, w = int(size_hw[0]), int(size_hw[1])
    centers = torch.as_tensor(centers, dtype=torch.float32)
    cx = centers[..., 0][..., None, None]
    cy = centers[..., 1][..., None, None]
    gridy = torch.arange(h, dtype=torch.float32, device=centers.device)[:, None]
    gridx = torch.arange(w, dtype=torch.float32, device=centers.device)[None, :]
    d2 = (gridx - cx) ** 2 + (gridy - cy) ** 2
    heat = torch.clamp(torch.exp(-d2 / 2.0 / float(sigma) / float(sigma)), max=1.0)
    return torch.where(heat < 0.0099, torch.zeros_like(heat), heat)


def render_targets(kpts, height: int, width: int, stride: int, sigma) -> torch.Tensor:
    """(..., K, 2) keypoints (x, y) at input resolution -> (..., height /
    stride, width / stride, K + 1) f32 targets, channel 0 the background."""
    centers = torch.trunc(torch.as_tensor(kpts, dtype=torch.float32)) / float(stride)
    joint_maps = gaussian_heatmaps(centers, (height // stride, width // stride), sigma)
    joint_maps = joint_maps.movedim(-3, -1)  # (..., K, H, W) -> (..., H, W, K)
    background = 1.0 - joint_maps.amax(dim=-1, keepdim=True)
    return torch.cat([background, joint_maps], dim=-1)
