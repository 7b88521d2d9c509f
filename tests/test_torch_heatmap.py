"""The port's Gaussian targets (unipose_tpu_torch/ops/heatmap.py) against
the JAX package's (unipose_tpu/ops/heatmap.py), on the same numpy inputs.
Tolerance: absolute error <= 1e-6 (values lie in [0, 1]; both sides take
the same f32 operations, so only exp's last bit may differ)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unipose_tpu.ops import heatmap as jax_heatmap
from unipose_tpu_torch.ops import heatmap

ATOL = 1e-6


def _kpts(rng, lead, k=14, size=368):
    """Keypoints in and beyond the image, fractional, with off-grid,
    negative and far-away ones planted."""
    kpts = rng.uniform(-40.0, size + 40.0, (*lead, k, 2)).astype(np.float32)
    flat = kpts.reshape(-1, k, 2)
    flat[:, 0] = (-20.0, 10.0)
    flat[:, 1] = (9000.0, 9000.0)
    flat[:, 2] = (100.3, 200.9)
    flat[:, 3] = (-0.7, 367.99)
    return kpts


@pytest.mark.parametrize("sigma", [3.0, 1.0])
@pytest.mark.parametrize("lead", [(3,), (2, 3)], ids=["BK2", "BTK2"])
def test_render_targets_matches_jax(sigma, lead):
    kpts = _kpts(np.random.RandomState(len(lead) * 10 + int(sigma)), lead)
    want = np.asarray(jax_heatmap.render_targets(jnp.asarray(kpts), 368, 368, 8, sigma))
    got = heatmap.render_targets(torch.from_numpy(kpts), 368, 368, 8, sigma).numpy()
    assert got.shape == want.shape == (*lead, 46, 46, 15)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # the targets are not trivially zero
    assert got[..., 1:].max() > 0.9


def test_render_targets_truncates_before_the_stride():
    """The port always truncates; JAX's ``truncate=False`` on keypoints
    truncated beforehand is the same function, and fractional keypoints
    land on other centers (the truncation is not a no-op)."""
    kpts = np.random.RandomState(3).uniform(0, 368, (2, 5, 2)).astype(np.float32)
    want = jax_heatmap.render_targets(jnp.asarray(np.trunc(kpts)), 368, 368, 8, 1.5, truncate=False)
    got = heatmap.render_targets(torch.from_numpy(kpts), 368, 368, 8, 1.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    untruncated = jax_heatmap.render_targets(jnp.asarray(kpts), 368, 368, 8, 1.5, truncate=False)
    assert np.abs(got.numpy() - np.asarray(untruncated)).max() > 1e-3


@pytest.mark.parametrize("sigma", [3.0, 1.0])
def test_gaussian_heatmaps_matches_jax(sigma):
    """Clamped at 1 and cut below 0.0099, as JAX's default ``clamp=True``;
    the cut is hit (JAX's ``clamp=False`` differs)."""
    centers = np.random.RandomState(4).uniform(-3, 50, (2, 7, 2)).astype(np.float32)
    want = jax_heatmap.gaussian_heatmaps(jnp.asarray(centers), (46, 40), sigma)
    got = heatmap.gaussian_heatmaps(torch.from_numpy(centers), (46, 40), sigma)
    assert got.shape == (2, 7, 46, 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    unclamped = jax_heatmap.gaussian_heatmaps(jnp.asarray(centers), (46, 40), sigma, clamp=False)
    assert not np.allclose(got.numpy(), np.asarray(unclamped), rtol=0, atol=ATOL)


def test_gaussian_kernel_matches_jax():
    want = jax_heatmap.gaussian_kernel(40, 30, 12.5, 7.0, 3.0)
    got = heatmap.gaussian_kernel(40, 30, 12.5, 7.0, 3.0)
    assert got.shape == (30, 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
