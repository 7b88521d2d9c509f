"""The port's UniPose image model against the JAX package's: weight carry,
strict loading, eval parity (max-norm relative error < 1e-4 in f32, the bar
of tests/test_parity_full.py:68-75) at reduced and full depth, the model's
variants, the bf16 policy, and the committed golden heatmaps.

Regenerate the golden file with
``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_models.py``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import ComposedUniPose, init_composed, max_rel_err, perturb_bn
from unipose_tpu.compat.torch_convert import convert_state_dict
from unipose_tpu.compat.torch_export import export_state_dict
from unipose_tpu.core.config import ModelConfig as JaxModelConfig
from unipose_tpu.models.unipose import init_model as jax_init_model
from unipose_tpu_torch.compat.from_jax import state_dict_from_jax
from unipose_tpu_torch.core.config import ModelConfig
from unipose_tpu_torch.models.unipose import (
    UniPose,
    build_model,
    init_model,
    load_numpy_state_dict,
    random_state_dict,
)

REDUCED = (1, 1, 1, 1)
GOLDEN = Path(__file__).parent / "data" / "golden_heatmaps_reduced_368.npz"


def _images(b, size, seed):
    """Seeded uint8 images, normalised (x - 128) / 256, NHWC f32."""
    img = np.random.RandomState(seed).randint(0, 256, (b, size, size, 3))
    return (img.astype(np.float32) - 128.0) / 256.0


def _port_forward(model, x_nhwc):
    with torch.no_grad():
        y = model(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2))
    if isinstance(y, tuple):
        return tuple(t.permute(0, 2, 3, 1).numpy() for t in y)
    return y.permute(0, 2, 3, 1).numpy()


def _port_from_jax(variables, **kwargs):
    model = UniPose(**kwargs)
    model.load_state_dict(state_dict_from_jax(variables))  # strict
    return model.eval()


@pytest.fixture(scope="module")
def full_depth():
    """The JAX package's own full-depth UniPose with perturbed BN."""
    model, variables = jax_init_model(
        JaxModelConfig(dataset="LSP", num_classes=14), jax.random.PRNGKey(0), input_size=64
    )
    return model, perturb_bn(variables, 1)


def test_state_dict_from_jax_equals_export_state_dict(full_depth):
    _, variables = full_depth
    ours = state_dict_from_jax(variables)
    ref = export_state_dict(variables, variant="image")
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert ours[k].numpy().dtype == v.dtype, k
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


def test_full_depth_loads_strict(full_depth):
    _, variables = full_depth
    model = build_model(ModelConfig())
    sd = state_dict_from_jax(variables)
    model.load_state_dict(sd, strict=True)
    assert set(model.state_dict()) == set(sd)
    w = model.backbone.layer3[22].bn2.running_var
    np.testing.assert_array_equal(
        w.numpy(), variables["batch_stats"]["backbone"]["layer3"]["22"]["bn2"]["running_var"]
    )


def test_full_depth_parity_128(full_depth):
    """Full ResNet-101 at 128x128: S = 8, so WASP skips taps."""
    model, variables = full_depth
    x = _images(1, 128, seed=2)
    want = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    got = _port_forward(_port_from_jax(variables), x)
    assert got.shape == want.shape == (1, 16, 16, 15)
    assert max_rel_err(got, want) < 1e-4


@pytest.mark.slow
def test_full_depth_parity_368(full_depth):
    model, variables = full_depth
    x = _images(1, 368, seed=3)
    want = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    got = _port_forward(_port_from_jax(variables), x)
    assert got.shape == want.shape == (1, 46, 46, 15)
    assert max_rel_err(got, want) < 1e-4


def test_reduced_depth_parity_368():
    """layers=(1,1,1,1) at 368x368: S = 23, so every WASP tap counts."""
    jmodel = ComposedUniPose(layers=REDUCED)
    variables = init_composed(jmodel, seed=4)
    x = _images(2, 368, seed=5)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    got = _port_forward(_port_from_jax(variables, layers=REDUCED), x)
    assert got.shape == want.shape == (2, 46, 46, 15)
    assert max_rel_err(got, want) < 1e-4


@pytest.mark.parametrize(
    "variant", [{"bbox_head": True}, {"stride": 4}, {"output_stride": 8}]
)
def test_variants_parity(variant):
    """The box head (two outputs), the resize to the input size when
    stride != 8, and output stride 8 (dilations 36, 24, 12)."""
    jmodel = ComposedUniPose(layers=REDUCED, **variant)
    variables = init_composed(jmodel, seed=6)
    x = _images(1, 64, seed=7)
    want = jmodel.apply(variables, jnp.asarray(x), train=False)
    got = _port_forward(_port_from_jax(variables, layers=REDUCED, **variant), x)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == np.shape(w)
        assert max_rel_err(g, np.asarray(w)) < 1e-4


def test_bf16_compute_keeps_f32_heatmaps():
    f32 = init_model(ModelConfig(), seed=0, device="cpu", layers=REDUCED)
    load_numpy_state_dict(f32, random_state_dict(f32, seed=8))
    bf16 = build_model(ModelConfig(compute_dtype=torch.bfloat16), layers=REDUCED)
    bf16.load_state_dict(f32.state_dict())
    bf16.eval()
    x = torch.from_numpy(_images(1, 64, seed=9)).permute(0, 3, 1, 2)
    with torch.no_grad():
        want, got = f32(x), bf16(x)
    assert got.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
    assert torch.isfinite(got).all()
    # bf16 keeps 8 bits of mantissa through ~20 layers: a few percent
    assert max_rel_err(got.numpy(), want.numpy()) < 5e-2


def test_bf16_compute_with_autograd_reaches_the_f32_weights():
    """With grads on, the conv casts its f32 weight inside the graph (no
    cached copy), so gradients land on the f32 parameters."""
    model = build_model(ModelConfig(compute_dtype=torch.bfloat16), layers=REDUCED).train()
    x = torch.from_numpy(_images(2, 64, seed=10)).permute(0, 3, 1, 2)
    model(x).square().mean().backward()
    for p in (model.backbone.conv1.weight, model.wasp.conv2.weight, model.decoder.last_conv[8].bias):
        assert p.grad is not None and p.grad.dtype == torch.float32
        assert torch.isfinite(p.grad).all() and p.grad.abs().sum() > 0


def test_init_model_is_seeded():
    a = init_model(ModelConfig(), seed=3, device="cpu", layers=REDUCED)
    b = init_model(ModelConfig(), seed=3, device="cpu", layers=REDUCED)
    c = init_model(ModelConfig(), seed=4, device="cpu", layers=REDUCED)
    assert not a.training
    w = "backbone.layer2.0.conv2.weight"
    torch.testing.assert_close(a.state_dict()[w], b.state_dict()[w], rtol=0, atol=0)
    assert not torch.equal(a.state_dict()[w], c.state_dict()[w])
    # He-normal fan_out: std sqrt(2 / (128 * 3 * 3))
    assert abs(a.state_dict()[w].std().item() / np.sqrt(2 / 1152) - 1) < 0.02


def golden_heatmaps_from_jax(golden):
    """The JAX package's heatmaps for the golden weights and input."""
    port = build_model(ModelConfig(), layers=tuple(golden["layers"]))
    state = random_state_dict(port, int(golden["weights_seed"]))
    jmodel = ComposedUniPose(layers=tuple(golden["layers"]))
    template = jax.jit(lambda k, x: jmodel.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))
    )
    variables, report = convert_state_dict(state, template, variant="image")
    assert all(k.endswith("num_batches_tracked") for k in report["skipped"])
    x = _images(1, 368, int(golden["input_seed"]))
    return np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False)), state, x


def test_golden_heatmaps():
    """Weights drawn by the port's numpy-seeded helper, pushed into the JAX
    model through unipose_tpu.compat.convert_state_dict: both frameworks
    still match the committed JAX heatmaps (chip_smoke.py holds the card's
    forward against the same file)."""
    golden = np.load(GOLDEN)
    jax_heat, state, x = golden_heatmaps_from_jax(golden)
    port = build_model(ModelConfig(), layers=tuple(golden["layers"])).eval()
    load_numpy_state_dict(port, state)
    got = _port_forward(port, x)
    assert got.shape == golden["heatmaps"].shape == (1, 46, 46, 15)
    assert max_rel_err(jax_heat, golden["heatmaps"]) < 1e-4
    assert max_rel_err(got, golden["heatmaps"]) < 1e-4


if __name__ == "__main__":
    seeds = {"layers": np.array(REDUCED), "weights_seed": np.array(0), "input_seed": np.array(1)}
    heat, _, _ = golden_heatmaps_from_jax(seeds)
    GOLDEN.parent.mkdir(exist_ok=True)
    np.savez(GOLDEN, heatmaps=heat.astype(np.float32), **seeds)
    print(f"wrote {GOLDEN} {heat.shape}")
