"""The port's heatmap_mse on CPU tensors (its plain versions) against the
JAX package's Pallas kernel run with ``interpret=True``, as
tests/test_pallas_loss.py holds that kernel against its materialising
reference.  Tolerances: the value to relative error 1e-5, the gradient to
rtol 1e-4, atol 1e-7 (the orders of the f32 sums differ).  Also the CUDA
kernels' tile plan, which is computed here in Python."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unipose_tpu.ops.pallas.heatmap_loss import heatmap_mse as jax_heatmap_mse
from unipose_tpu_torch.ops.kernels import heatmap_mse as hm


def _inputs(seed, b, k, h=46, w=46):
    rng = np.random.RandomState(seed)
    pred = rng.randn(b, h, w, k + 1).astype(np.float32)
    kpts = rng.uniform(0, 8 * max(h, w), (b, k, 2)).astype(np.float32)
    # off the grid, negative, far away and fractional (test_pallas_loss.py:38-46)
    kpts[0, :3] = ((-20.0, 10.0), (9000.0, 9000.0), (100.3, 200.9))
    return pred, kpts


@pytest.mark.parametrize("sigma", [3.0, 1.0])
@pytest.mark.parametrize("b,k", [(3, 14), (2, 19)], ids=["LSP", "NTID"])
def test_value_and_grad_match_jax_interpret(sigma, b, k):
    pred, kpts = _inputs(int(sigma) * 7 + b, b, k)
    want = jax_heatmap_mse(jnp.asarray(pred), jnp.asarray(kpts), 8, sigma, True)
    want_grad = jax.grad(lambda p: jax_heatmap_mse(p, jnp.asarray(kpts), 8, sigma, True))(
        jnp.asarray(pred)
    )
    p = torch.from_numpy(pred).requires_grad_()
    got = hm.heatmap_mse(p, torch.from_numpy(kpts), 8, sigma)
    got.backward()
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad), rtol=1e-4, atol=1e-7)


def test_backward_reference_matches_autograd_of_the_forward():
    pred, kpts = _inputs(5, 2, 14)
    p = torch.from_numpy(pred).requires_grad_()
    k = torch.from_numpy(kpts)
    g = torch.tensor(0.7)
    (hm.heatmap_mse_reference(p, k, 8, 3.0) * g).backward()
    got = hm.heatmap_mse_backward_reference(p.detach(), k, g, 8, 3.0)
    np.testing.assert_allclose(got.numpy(), p.grad.numpy(), rtol=1e-5, atol=1e-9)


def test_keypoints_get_no_gradient_and_the_cpu_path_counts_no_launch():
    pred, kpts = _inputs(6, 1, 14)
    p = torch.from_numpy(pred).requires_grad_()
    k = torch.from_numpy(kpts).requires_grad_()
    before = (hm.heatmap_mse.launches, hm.heatmap_mse_backward.launches)
    hm.heatmap_mse(p, k).backward()
    assert k.grad is None and p.grad is not None
    assert (hm.heatmap_mse.launches, hm.heatmap_mse_backward.launches) == before


def test_bf16_pred_computes_in_f32_and_returns_a_bf16_gradient():
    pred, kpts = _inputs(8, 2, 14)
    p = torch.from_numpy(pred).bfloat16().requires_grad_()
    loss = hm.heatmap_mse(p, torch.from_numpy(kpts))
    loss.backward()
    assert loss.dtype == torch.float32 and p.grad.dtype == torch.bfloat16
    want = jax_heatmap_mse(jnp.asarray(p.detach().float().numpy()), jnp.asarray(kpts), 8, 3.0, True)
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)


def _strided(kpts):
    """(B, K, 3) keypoints with a visibility column, and their [..., :2] view."""
    kpts3 = np.concatenate([kpts, np.full(kpts.shape[:2] + (1,), 7.0, np.float32)], -1)
    view = torch.from_numpy(kpts3)[..., :2]
    assert view.stride() == (3 * kpts.shape[1], 3, 1)
    return view


@pytest.mark.parametrize("sigma", [3.0, 1.0])
@pytest.mark.parametrize("h,w", [(46, 46), (45, 37), (8, 8)])
def test_plain_versions_read_strided_keypoints(sigma, h, w):
    """The train step hands the loss the (B, K, 3)[..., :2] view of its
    keypoints: the plain versions read it as the contiguous (B, K, 2) and
    agree with the JAX kernel."""
    pred, kpts = _inputs(h + w, 2, 14, h, w)
    view, dense = _strided(kpts), torch.from_numpy(kpts)
    want = jax_heatmap_mse(jnp.asarray(pred), jnp.asarray(kpts), 8, sigma, True)
    want_grad = jax.grad(lambda p: jax_heatmap_mse(p, jnp.asarray(kpts), 8, sigma, True))(
        jnp.asarray(pred)
    )
    p = torch.from_numpy(pred)
    g = torch.tensor(1.0)
    got = hm.heatmap_mse_reference(p, view, 8, sigma)
    got_grad = hm.heatmap_mse_backward_reference(p, view, g, 8, sigma)
    assert torch.equal(got, hm.heatmap_mse_reference(p, dense, 8, sigma))
    assert torch.equal(got_grad, hm.heatmap_mse_backward_reference(p, dense, g, 8, sigma))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(got_grad.numpy(), np.asarray(want_grad), rtol=1e-4, atol=1e-7)


# chip_smoke.py's HM_CASES (batch, joints) at the heatmap sizes it runs
@pytest.mark.parametrize("h,w", [(46, 46), (45, 37), (16, 16), (8, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,k", [(1, 14), (8, 14), (32, 14), (8, 19)])
def test_tile_plan_covers_every_pixel_once_in_16_byte_runs(b, k, dtype, h, w):
    sms, elem = 132, torch.finfo(dtype).bits // 8
    plan = hm.tile_plan(b, h, w, k + 1, dtype, sms)
    p, pixels = plan.tile_pixels, b * h * w
    assert p % 8 == 0 and 8 <= p <= hm.THREADS
    assert p * (k + 1) * elem % 16 == 0  # every tile starts at pred's offset mod 16
    assert plan.tiles == -(-pixels // p) and plan.partials == plan.blocks
    assert plan.smem_bytes <= hm.SMEM_LIMIT
    seen = np.zeros(pixels, np.int64)
    for block in range(plan.blocks):
        tiles = range(block * plan.tiles_per_block, min((block + 1) * plan.tiles_per_block, plan.tiles))
        assert len(tiles) > 0  # no block without work
        for t in tiles:
            q0, q1 = t * p, min((t + 1) * p, pixels)
            seen[q0:q1] += 1
            # the centers table holds every image the tile touches
            assert (q1 - 1) // (h * w) - q0 // (h * w) + 1 <= min(b, (p - 1) // (h * w) + 2)
    assert (seen == 1).all()
    if pixels >= 8 * sms:
        assert plan.tiles >= sms  # the card is full
    if (b, h, w, k, dtype) == (8, 46, 46, 14, torch.float32):  # the train step's loss
        assert plan.blocks >= sms and plan.tiles_per_block == 1


def test_tile_plan_gives_a_block_several_tiles_past_its_blocks_an_sm():
    plan = hm.tile_plan(32, 46, 46, 15, torch.float32, 8)
    assert plan.tiles_per_block == -(-plan.tiles // (hm.BLOCKS_PER_SM * 8)) > 1
    assert plan.blocks <= hm.BLOCKS_PER_SM * 8
    assert (plan.blocks - 1) * plan.tiles_per_block < plan.tiles <= plan.blocks * plan.tiles_per_block


def test_tile_plan_keeps_wide_heatmaps_in_shared_memory():
    """A generic width (here 200 channels) shrinks the tile to fit."""
    plan = hm.tile_plan(4, 46, 46, 200, torch.float32, 132)
    assert plan.tile_pixels % 8 == 0 and plan.smem_bytes <= hm.SMEM_LIMIT
    assert plan.tile_pixels < 128
