"""Shared helpers for the tests that hold ``unipose_tpu_torch`` against
``unipose_tpu``: the parity measure, seeded BN perturbation of JAX
variables, a JAX UniPose whose backbone depth can be cut, and the same cut
for the JAX UniPoseLSTM."""

from __future__ import annotations

import contextlib
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from flax import linen as nn

from unipose_tpu.models.decoder import Decoder
from unipose_tpu.models.resnet import ResNet101
from unipose_tpu.models.wasp import WASP
from unipose_tpu.ops.resize import bilinear_resize


def max_rel_err(ours, ref) -> float:
    """max|a - b| over max|b|: the full-network parity measure of
    tests/test_parity_full.py:68-75 (randomised BN blows activations up, so
    elementwise rtol near zero crossings only measures f32 noise)."""
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


def perturb_bn(variables, seed: int):
    """Seeded random BN affine parameters and running statistics, as
    tests/test_parity_full.py:47-61 draws them, so eval-mode BN is a real
    transform.  Returns a new numpy tree."""
    rng = np.random.RandomState(seed)
    variables = jax.device_get(variables)

    def walk(params, stats):
        params, stats = dict(params), dict(stats)
        for k, v in stats.items():
            if isinstance(v, dict) and "running_mean" in v:
                c = v["running_mean"].shape
                stats[k] = {
                    "running_mean": (0.1 * rng.randn(*c)).astype(np.float32),
                    "running_var": (0.8 + 0.4 * rng.rand(*c)).astype(np.float32),
                }
                params[k] = {
                    "weight": (1.0 + 0.1 * rng.randn(*c)).astype(np.float32),
                    "bias": (0.05 * rng.randn(*c)).astype(np.float32),
                }
            elif isinstance(v, dict):
                params[k], stats[k] = walk(params[k], v)
        return params, stats

    params, stats = walk(variables["params"], variables["batch_stats"])
    return {"params": params, "batch_stats": stats}


class ComposedUniPose(nn.Module):
    """``unipose_tpu.models.unipose.UniPose`` composed from its parts under
    the same names, with the backbone depth as a field."""

    layers: Tuple[int, int, int, int] = (1, 1, 1, 1)
    num_classes: int = 14
    output_stride: int = 16
    stride: int = 8
    bbox_head: bool = False
    freeze_bn: bool = False

    @nn.compact
    def __call__(self, x, *, train: bool = False):
        feats, low = ResNet101(
            output_stride=self.output_stride, layers=self.layers,
            freeze_bn=self.freeze_bn, name="backbone",
        )(x, train=train)
        y = WASP(output_stride=self.output_stride, freeze_bn=self.freeze_bn, name="wasp")(
            feats, train=train
        )
        y = Decoder(
            self.num_classes, bbox_head=self.bbox_head, freeze_bn=self.freeze_bn,
            name="decoder",
        )(y, low, train=train)
        if self.stride != 8:
            y = bilinear_resize(y, x.shape[1:3])
        y = y.astype(jnp.float32)
        if self.bbox_head:
            k = self.num_classes + 1
            return y[..., :k], y[..., k:]
        return y


def init_composed(module: ComposedUniPose, seed: int, size: int = 64):
    """Variables of ``module`` (parameter shapes do not depend on ``size``),
    BN perturbed from ``seed``."""
    x = jnp.zeros((1, size, size, 3), jnp.float32)
    variables = jax.jit(lambda k, x: module.init(k, x, train=False))(
        jax.random.PRNGKey(seed), x
    )
    return perturb_bn(variables, seed + 1)


@contextlib.contextmanager
def reduced_lstm_depth(layers: Tuple[int, int, int, int]):
    """Inside the block, the JAX ``UniPoseLSTM`` builds its backbone with
    ``layers`` (the JAX model has no depth field; its parameter names do not
    change).  Every trace of the model, ``jit`` and ``apply``, must happen
    inside."""
    import pytest

    from unipose_tpu.models import unipose_lstm

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(unipose_lstm, "ResNet101", functools.partial(ResNet101, layers=layers))
        yield
