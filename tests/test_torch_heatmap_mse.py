"""The port's heatmap_mse on CPU tensors (its plain versions) against the
JAX package's Pallas kernel run with ``interpret=True``, as
tests/test_pallas_loss.py holds that kernel against its materialising
reference.  Tolerances: the value to relative error 1e-5, the gradient to
rtol 1e-4, atol 1e-7 (the orders of the f32 sums differ)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unipose_tpu.ops.pallas.heatmap_loss import heatmap_mse as jax_heatmap_mse
from unipose_tpu_torch.ops.kernels import heatmap_mse as hm


def _inputs(seed, b, k):
    rng = np.random.RandomState(seed)
    pred = rng.randn(b, 46, 46, k + 1).astype(np.float32)
    kpts = rng.uniform(0, 368, (b, k, 2)).astype(np.float32)
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
