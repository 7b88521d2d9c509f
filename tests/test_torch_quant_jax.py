"""The port's int8 front end against the JAX package on the same weights
and the same quantized state, at full depth (JAX's int8 forwards build
layer3's 23 blocks), 64x64: calibration, the w8a8 front end's codes, and
the image and video int8 forwards on JAX's ``Int8Frontend`` carried across
by ``compat/from_jax.py::int8_frontend_from_jax``.

What is read, and the tolerances (read first, then fixed):
  * Calibration: activation scales within 1e-5 relative (read 4.8e-7:
    f32 convs summed in another order); weight scales 1e-6, codes equal
    but at rounding ties.
  * The w8a8 front end: a requant code can flip where the f32 epilogue
    rounds differently, so the codes of its two outputs are compared
    directly and the share that differ is held at 1e-4 (read: 0).  The
    heatmaps after the f32 layer3-decoder are held at the parity bar, 1e-4
    max-norm relative (read 3.0e-6), and at JAX's own bar against the
    float model, 0.08 relative L2 (tests/test_quant.py:138-141).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import (  # two_threads_for_the_module: an autouse fixture
    codes_equal_but_ties,
    jax_variables,
    max_rel_err,
    rel_l2,
    two_threads_for_the_module,
)
from unipose_tpu.models import quantized as jax_quantized
from unipose_tpu.models.unipose import UniPose as JaxUniPose
from unipose_tpu.models.unipose_lstm import UniPoseLSTM as JaxUniPoseLSTM
from unipose_tpu.ops import quant as jax_quant
from unipose_tpu_torch.compat.from_jax import int8_frontend_from_jax
from unipose_tpu_torch.core.config import ModelConfig
from unipose_tpu_torch.models import quantized
from unipose_tpu_torch.models.unipose import build_model, load_numpy_state_dict, random_state_dict
from unipose_tpu_torch.ops import quant
from unipose_tpu_torch.ops.kernels import conv_i8 as kernel

VIDEO = ModelConfig(dataset="Penn_Action", num_classes=13, variant="lstm")


@pytest.fixture(scope="module")
def jax_int8():
    """Full-depth image and video models (the JAX int8 forwards build
    layer3's 23 blocks) on the same seeded weights in both packages, the
    video model's backbone equal to the image model's; JAX's quantized
    front end prepared once, at 64x64, and carried to the port.  JAX runs
    its forwards op by op, so the video tower (B*T = 2 frames) reuses the
    image tower's (batch 2) compiled ops."""
    image = build_model(ModelConfig())
    state = random_state_dict(image, seed=8)
    load_numpy_state_dict(image, state)
    video = build_model(VIDEO)
    vstate = random_state_dict(video, seed=10)
    vstate.update({k: v for k, v in state.items() if k.startswith("backbone.")})
    load_numpy_state_dict(video, vstate)

    rng = np.random.RandomState(7)
    x = ((rng.rand(2, 64, 64, 3) * 255 - 128) / 256).astype(np.float32)
    frames = ((rng.rand(1, 2, 64, 64, 3) * 255 - 128) / 256).astype(np.float32)
    centermap = rng.rand(1, 2, 64, 64, 1).astype(np.float32)

    jimage = jax_variables(JaxUniPose(num_classes=14, dtype=jnp.float32), state, (1, 64, 64, 3))
    fe = jax_quantized.prepare_int8_frontend(jimage, jnp.asarray(x))
    heat = jax_quantized.int8_image_forward(jimage, fe, jnp.asarray(x), num_classes=14, dtype=jnp.float32)
    jvideo = jax_variables(JaxUniPoseLSTM(num_classes=13, dtype=jnp.float32), vstate,
                            (1, 2, 64, 64, 3), (1, 2, 64, 64, 1), variant="lstm")
    vheat = jax_quantized.int8_video_forward(
        jvideo, fe, jnp.asarray(frames), jnp.asarray(centermap), num_classes=13, dtype=jnp.float32
    )
    return {
        "image": image.eval(), "video": video.eval(), "jimage": jimage, "fe": jax.device_get(fe),
        "x": x, "frames": frames, "centermap": centermap,
        "heat": np.asarray(heat), "vheat": np.asarray(vheat),
    }


def test_calibrate_frontend_matches_jax(jax_int8):
    folded = quant.fold_frontend(jax_int8["image"].backbone)
    scales = quant.calibrate_frontend(folded, torch.from_numpy(jax_int8["x"]))
    want = jax_int8["fe"].act_scales
    assert set(scales) == set(want)
    assert max(abs(scales[k] - want[k]) / want[k] for k in want) <= 1e-5
    qconvs = quant.quantize_frontend(folded)
    for name, jqc in jax_int8["fe"].qconvs.items():
        assert max_rel_err(qconvs[name].w_scale, jqc.w_scale) <= 1e-6
        assert (qconvs[name].stride, qconvs[name].padding) == (jqc.stride, jqc.padding)
        codes_equal_but_ties(qconvs[name].w_i8, jqc.w_i8, folded[name].w, qconvs[name].w_scale)


def test_frontend_int8_matches_jax_codes(jax_int8):
    fe = jax_int8["fe"]
    out, low = int8_frontend_from_jax(fe)(torch.from_numpy(jax_int8["x"]))
    jout, jlow = jax_quant.frontend_int8(fe.qconvs, fe.act_scales, jnp.asarray(jax_int8["x"]), return_low=True)
    for got, want, point in ((out, jout, "layer2.3.out"), (low, jlow, "layer1.2.out")):
        s = fe.act_scales[point]
        codes, jcodes = np.round(got.numpy() / s), np.round(np.asarray(want) / s)
        assert float((codes != jcodes).mean()) <= 1e-4, point
        assert np.abs(codes - jcodes).max() <= 1, point


def test_int8_image_forward_matches_jax(jax_int8):
    model, x = jax_int8["image"], torch.from_numpy(jax_int8["x"])
    fe = int8_frontend_from_jax(jax_int8["fe"])
    with torch.no_grad():
        got = quantized.int8_image_forward(model, fe, x, dtype=torch.float32)
        ref = model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == jax_int8["heat"].shape == (2, 8, 8, 15)
    assert max_rel_err(got, jax_int8["heat"]) < 1e-4
    assert rel_l2(got, ref) < 0.08  # JAX's bar against the float model


def test_int8_video_forward_matches_jax(jax_int8):
    model = jax_int8["video"]
    frames, centermap = torch.from_numpy(jax_int8["frames"]), torch.from_numpy(jax_int8["centermap"])
    fe = int8_frontend_from_jax(jax_int8["fe"])
    with torch.no_grad():
        got = quantized.int8_video_forward(model, fe, frames, centermap, dtype=torch.float32)
        ref, _ = model(frames.permute(0, 1, 4, 2, 3), centermap.permute(0, 1, 4, 2, 3))
    assert got.shape == jax_int8["vheat"].shape == (1, 2, 8, 8, 14)
    assert max_rel_err(got, jax_int8["vheat"]) < 1e-4
    assert rel_l2(got, ref.permute(0, 1, 3, 4, 2)) < 0.08


def test_int8_frontend_from_jax_carries_every_conv(jax_int8):
    fe = int8_frontend_from_jax(jax_int8["fe"])
    jfe = jax_int8["fe"]
    assert fe.names == tuple(jfe.qconvs) and fe.act_scales == {k: float(v) for k, v in jfe.act_scales.items()}
    for name, qc in fe.qconvs.items():
        np.testing.assert_array_equal(qc.w_i8.numpy(), np.asarray(jfe.qconvs[name].w_i8))
        assert torch.equal(kernel.unpack_weight(qc.w_packed, *qc.w_i8.shape[:3]), qc.w_i8)
    with pytest.raises(NotImplementedError):
        quantized.int8_image_forward(jax_int8["image"], fe, torch.zeros(1, 64, 64, 3), output_stride=8)
