"""unipose_tpu_torch.ops and preprocessing against their JAX counterparts,
on the same seeded numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unipose_tpu.ops.pooling import max_pool2d as jax_max_pool2d
from unipose_tpu.ops.resize import bilinear_resize as jax_bilinear_resize
from unipose_tpu.train.steps import preprocess_images as jax_preprocess
from unipose_tpu_torch.ops.pooling import max_pool2d
from unipose_tpu_torch.ops.resize import bilinear_resize
from unipose_tpu_torch.train.steps import preprocess_images


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.numpy(), 1, -1)


# The sizes the model resizes at: GAP 1->23, decoder 23->46, output 46->368.
@pytest.mark.parametrize("in_size,out_size", [(1, 23), (23, 46), (46, 368)])
def test_bilinear_resize_matches_jax(in_size, out_size):
    x = np.random.RandomState(in_size).randn(2, in_size, in_size, 3).astype(np.float32)
    want = np.asarray(jax_bilinear_resize(jnp.asarray(x), (out_size, out_size)))
    got = _nhwc(bilinear_resize(_nchw(x), (out_size, out_size)))
    assert got.shape == want.shape == (2, out_size, out_size, 3)
    # both are convex pairs of the same two pixels in f32: rounding only
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size", [92, 23, 8, 7])
def test_max_pool2d_matches_jax(size):
    x = np.random.RandomState(size).randn(2, size, size, 4).astype(np.float32)
    want = np.asarray(jax_max_pool2d(jnp.asarray(x), 3, 2, 1))
    got = _nhwc(max_pool2d(_nchw(x), 3, 2, 1))
    np.testing.assert_array_equal(got, want)  # a max is exact


def test_max_pool2d_pads_with_minus_inf():
    """A border window of all-negative pixels keeps its real max, not 0."""
    x = -1.0 - np.random.RandomState(0).rand(1, 5, 5, 2).astype(np.float32)
    got = _nhwc(max_pool2d(_nchw(x), 3, 2, 1))
    np.testing.assert_array_equal(got, np.asarray(jax_max_pool2d(jnp.asarray(x), 3, 2, 1)))
    assert (got < 0).all()


def test_preprocess_images_matches_jax():
    img = np.random.RandomState(0).randint(0, 256, (2, 16, 16, 3)).astype(np.uint8)
    want = np.asarray(jax_preprocess(jnp.asarray(img, jnp.float32)))
    got = preprocess_images(torch.from_numpy(img))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)  # exact in f32
