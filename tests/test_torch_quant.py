"""The port's int8 front end (ops/quant.py, models/quantized.py, the
``conv_i8`` op): the int32 accumulator against JAX's exactly, BN folding
and weight quantization against JAX's, and twins of every test of
tests/test_quant.py on the port alone.  The full-depth comparisons with
JAX on the same quantized state: tests/test_torch_quant_jax.py.

What is read, and the tolerances (read first, then fixed):
  * ``conv_i8``: equal, int32 for int32, including sums above 2^24.
  * ``fold_bn``: folded weights and biases within 1e-6 relative (JAX's
    ``lax.rsqrt`` and torch's ``rsqrt`` may round apart by an ulp).
  * ``quantize_weight``: scales within 1e-6 relative; codes equal except
    where w / scale lies within 1e-4 of a rounding tie (read: 1 code of
    the front end's 1.4 M differed, at a tie).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from torch_parity import (  # two_threads_for_the_module: an autouse fixture
    codes_equal_but_ties,
    max_rel_err,
    rel_l2,
    two_threads_for_the_module,
)
from unipose_tpu.ops import quant as jax_quant
from unipose_tpu_torch.core.config import ModelConfig
from unipose_tpu_torch.models import quantized
from unipose_tpu_torch.models.layers import batch_norm, conv
from unipose_tpu_torch.models.unipose import build_model
from unipose_tpu_torch.ops import quant
from unipose_tpu_torch.ops.kernels import conv_i8 as kernel

FRONT = (3, 4, 1, 1)  # the front end at full depth, layer3/4 cut (port-only tests)
VIDEO = ModelConfig(dataset="Penn_Action", num_classes=13, variant="lstm")


# ---------------------------------------------------------------------------
# conv_i8: the int32 accumulator, exactly
# ---------------------------------------------------------------------------

# (Cin, Cout, k, stride, padding, H): the front end's kinds of conv, scaled
# down: conv1's 7x7/2 over 3 channels, layer2's 3x3/2, the downsample's
# 1x1/2, a 3x3/1 and a 1x1 over 256.
CONV_CASES = {
    "7x7/2 cin3": (3, 64, 7, 2, 3, 21),
    "3x3/2 cin128": (128, 32, 3, 2, 1, 9),
    "1x1/2 cin256": (256, 24, 1, 2, 0, 7),
    "3x3/1 cin64": (64, 16, 3, 1, 1, 8),
    "1x1 cin256": (256, 40, 1, 1, 0, 5),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_i8_reference_equals_jax(case):
    cin, cout, k, stride, padding, h = CONV_CASES[case]
    rng = np.random.RandomState(sorted(CONV_CASES).index(case))
    x = rng.randint(-127, 128, (2, h, h + 1, cin)).astype(np.int8)
    w = rng.randint(-127, 128, (k, k, cin, cout)).astype(np.int8)
    x[0] = 127  # saturated image and filters: the largest sums
    w[..., 0] = 127
    w[..., 1] = -127
    want = np.asarray(jax_quant.conv_i8(
        jnp.asarray(x), jax_quant.QuantConv(jnp.asarray(w), jnp.ones(cout), jnp.zeros(cout), stride, padding)
    ))
    got = kernel.conv_i8_reference(torch.from_numpy(x), torch.from_numpy(w), stride, padding)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the op on a CPU tensor (the plain version behind the packed weights)
    qc = quant.QuantConv(torch.from_numpy(w), torch.ones(cout), torch.zeros(cout), stride, padding)
    np.testing.assert_array_equal(quant.conv_i8(torch.from_numpy(x), qc).numpy(), want)
    if k * k * cin >= 1152:
        assert np.abs(want).max() > 2**24  # beyond what an f32 conv adds exactly


def test_pack_weight_round_trip():
    w = torch.from_numpy(np.random.RandomState(3).randint(-127, 128, (7, 7, 3, 64)).astype(np.int8))
    packed = kernel.pack_weight(w)
    assert packed.shape == (64, 160) and packed.dtype == torch.int8
    assert not packed[:, 147:].any()
    assert torch.equal(kernel.unpack_weight(packed, 7, 7, 3), w)


# ---------------------------------------------------------------------------
# Twins of tests/test_quant.py, on the port alone
# ---------------------------------------------------------------------------


def _randomize_bn(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Every BN's parameters and statistics drawn as tests/test_quant.py's
    ``_randomize_bn`` draws them, so that folding is really tested."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.running_mean.copy_(torch.from_numpy(rng.randn(c) * 0.2))
                m.bias.copy_(torch.from_numpy(rng.randn(c) * 0.2))
                m.running_var.copy_(torch.from_numpy(rng.rand(c) * 2 + 0.1))
                m.weight.copy_(torch.from_numpy(rng.rand(c) + 0.5))
    return model


def _model(config: ModelConfig, seed: int, layers=FRONT) -> torch.nn.Module:
    from unipose_tpu_torch.models.layers import init_weights

    model = build_model(config, layers=layers)
    init_weights(model, torch.Generator().manual_seed(seed))
    return _randomize_bn(model, seed + 1).eval()


def test_fold_bn_matches_conv_bn():
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(2, 8, 10, 10).astype(np.float32))
    c = conv(8, 16, 3, stride=2, padding=1)
    bn = _randomize_bn(torch.nn.Sequential(batch_norm(16)), 2)[0].eval()
    with torch.no_grad():
        ref = bn(c(x))
        fc = quant.fold_bn(
            c.weight.permute(2, 3, 1, 0),
            {"weight": bn.weight, "bias": bn.bias},
            {"running_mean": bn.running_mean, "running_var": bn.running_var},
            stride=2, padding=1,
        )
        got = F.conv2d(x, fc.w.permute(3, 2, 0, 1), fc.b, stride=2, padding=1)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def frontend():
    """A ResNet101 with randomized BN (the front end at full depth) and its
    f32 layer2 output, read by a hook on the modules' eval forward."""
    model = _model(ModelConfig(), seed=3).backbone
    rng = np.random.RandomState(3)
    x = torch.from_numpy(((rng.rand(2, 96, 96, 3) * 255 - 128) / 256).astype(np.float32))
    seen = {}
    model.layer2.register_forward_hook(lambda m, i, o: seen.update(out=o))
    with torch.no_grad():
        model(x.permute(0, 3, 1, 2))
    return model, x, seen["out"].permute(0, 2, 3, 1)


def test_frontend_f32_matches_model(frontend):
    model, x, ref = frontend
    out = quant.frontend_f32(quant.fold_frontend(model), x)
    assert out.shape == ref.shape == (2, 12, 12, 512)
    # folding reassociates (w*s) vs (conv then scale) in f32, as in JAX
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-3, atol=5e-3)


def test_int8_frontend_drift_bounded(frontend):
    model, x, ref = frontend
    folded = quant.fold_frontend(model)
    scales = quant.calibrate_frontend(folded, x)
    assert set(scales) == {
        "input",
        "stem",
        *(f"layer{L}.{i}.{p}" for L, n in ((1, 3), (2, 4)) for i in range(n)
          for p in ("relu1", "relu2", "out")),
    }
    qconvs = quant.quantize_frontend(folded)
    out = quant.frontend_int8(qconvs, scales, x, scales=quant.combined_scales(qconvs, scales))
    assert out.dtype == torch.float32
    assert rel_l2(out, ref) < 0.08  # JAX's bar: w8a8 through 8 requant points


def test_int8_image_forward_matches_model():
    model = _model(ModelConfig(), seed=7)
    rng = np.random.RandomState(7)
    x = torch.from_numpy(((rng.rand(2, 96, 96, 3) * 255 - 128) / 256).astype(np.float32))
    with torch.no_grad():
        ref = model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        _, forward = quantized.int8_forward_fn(model, x, dtype=torch.float32)
        out = forward(x)
    assert out.shape == ref.shape == (2, 12, 12, 15)
    assert rel_l2(out, ref) < 0.08


def test_int8_video_forward_matches_model():
    model = _model(VIDEO, seed=9)
    rng = np.random.RandomState(9)
    b, t, size = 1, 3, 96
    frames = torch.from_numpy(((rng.rand(b, t, size, size, 3) * 255 - 128) / 256).astype(np.float32))
    centermap = torch.from_numpy(rng.rand(b, t, size, size, 1).astype(np.float32))
    with torch.no_grad():
        ref, _ = model(frames.permute(0, 1, 4, 2, 3), centermap.permute(0, 1, 4, 2, 3))
        ref = ref.permute(0, 1, 3, 4, 2)
        _, forward = quantized.int8_video_forward_fn(model, frames, dtype=torch.float32)
        out = forward(frames, centermap)
    assert out.shape == ref.shape == (b, t, size // 8, size // 8, 14)
    assert rel_l2(out, ref) < 0.08


def test_int8_clip_artifact_matches_forward():
    """The int8 video forward (cli/export.py --int8_frontend on UniPose-LSTM,
    not streaming) exports, loads and equals the live quantized forward;
    the program holds each front-end conv's int8 weights once, packed."""
    from unipose_tpu_torch.compat import export

    model = _model(VIDEO, seed=14)
    rng = np.random.RandomState(14)
    frames = torch.from_numpy(((rng.rand(1, 2, 64, 64, 3) * 255 - 128) / 256).astype(np.float32))
    centermap = torch.from_numpy(rng.rand(1, 2, 64, 64, 1).astype(np.float32))
    _, forward = quantized.int8_video_forward_fn(model, frames, dtype=torch.float32)
    ep = export.load_exported(export.export_inference(model, (1, 2, 64, 64, 3), video=True, forward=forward))
    got = ep.module()(frames, centermap)
    with torch.no_grad():
        want = forward(frames, centermap)
    assert got.shape == (1, 2, 8, 8, 14)
    assert max_rel_err(got.numpy(), want.numpy()) <= 1e-6
    int8 = [v for v in ep.state_dict.values() if v.dtype == torch.int8]
    assert len(int8) == 24 and all(v.dim() == 2 for v in int8)


def test_quantize_weight_roundtrip():
    w = torch.from_numpy(np.random.RandomState(5).randn(3, 3, 4, 8).astype(np.float32))
    w_i8, s = quant.quantize_weight(w)
    assert w_i8.dtype == torch.int8 and s.shape == (8,)
    err = (w_i8.float() * s - w).abs()
    assert bool((err <= s / 2 + 1e-7).all())


# ---------------------------------------------------------------------------
# Against JAX on the same weights
# ---------------------------------------------------------------------------


def test_fold_bn_and_quantize_weight_match_jax():
    rng = np.random.RandomState(11)
    w = rng.randn(3, 3, 8, 16).astype(np.float32)
    params = {"weight": (rng.rand(16) + 0.5).astype(np.float32), "bias": (rng.randn(16) * 0.2).astype(np.float32)}
    stats = {"running_mean": (rng.randn(16) * 0.2).astype(np.float32),
             "running_var": (rng.rand(16) * 2 + 0.1).astype(np.float32)}
    want = jax_quant.fold_bn(jnp.asarray(w), params, stats, stride=2, padding=1)
    got = quant.fold_bn(torch.from_numpy(w), {k: torch.from_numpy(v) for k, v in params.items()},
                        {k: torch.from_numpy(v) for k, v in stats.items()}, stride=2, padding=1)
    assert (got.stride, got.padding) == (want.stride, want.padding) == (2, 1)
    assert max_rel_err(got.w, want.w) <= 1e-6 and max_rel_err(got.b, want.b) <= 1e-6
    w_i8, scale = quant.quantize_weight(got.w)
    jw_i8, jscale = jax_quant.quantize_weight(want.w)
    assert max_rel_err(scale, jscale) <= 1e-6
    codes_equal_but_ties(w_i8, jw_i8, got.w, scale)
