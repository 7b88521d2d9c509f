"""The port's fused stem (fold + plain version + wrapper) and its ResNet's
stem paths against the JAX package: the Pallas kernel in interpret mode,
the standard conv/BN/ReLU/maxpool stem, and ``ResNet101(stem_s2d=True)``,
on the same seeded weights and inputs.  The CUDA kernel itself is held
against the plain version by tests/test_torch_kernels_cuda.py (on a card)
and by chip_smoke.py."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from flax import linen as nn

from torch_parity import max_rel_err, perturb_bn
from unipose_tpu.models.layers import Conv, TorchBatchNorm
from unipose_tpu.models.resnet import ResNet101 as JaxResNet101
from unipose_tpu.models.resnet import s2d_stem_kernel as jax_s2d_stem_kernel
from unipose_tpu.models.resnet import space_to_depth as jax_space_to_depth
from unipose_tpu.ops.pallas.stem import fold_stem_params as jax_fold
from unipose_tpu.ops.pallas.stem import fused_stem as jax_fused_stem
from unipose_tpu.ops.pooling import max_pool2d as jax_max_pool2d
from unipose_tpu_torch.compat.from_jax import state_dict_from_jax
from unipose_tpu_torch.core.config import ModelConfig
from unipose_tpu_torch.models.resnet import ResNet101, s2d_stem_kernel, space_to_depth
from unipose_tpu_torch.models.unipose import build_model, load_numpy_state_dict, random_state_dict
from unipose_tpu_torch.ops.kernels import fused_stem as port_kernel

REDUCED = (1, 1, 1, 1)


class StandardStem(nn.Module):
    """The JAX package's stem as tests/test_pallas_stem.py builds it."""

    @nn.compact
    def __call__(self, x):
        x = Conv(64, 7, stride=2, padding=3, name="conv1")(x)
        x = TorchBatchNorm(name="bn1")(x, use_running_average=True)
        return jax_max_pool2d(nn.relu(x), 3, 2, 1)


def _input(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pair(stem_s2d: bool, seed: int):
    """A JAX reduced-depth ResNet-101 (BN perturbed) and the port's carrying
    the same weights, in eval mode."""
    jnet = JaxResNet101(layers=REDUCED, stem_s2d=stem_s2d)
    variables = jax.jit(lambda k, x: jnet.init(k, x, train=False))(
        jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 3))
    )
    variables = perturb_bn(variables, seed + 1)
    port = ResNet101(layers=REDUCED, stem_s2d=stem_s2d)
    port.load_state_dict(state_dict_from_jax(variables))
    return jnet, variables, port.eval()


def test_space_to_depth_and_s2d_kernel_match_jax():
    x = _input((2, 8, 6, 3), seed=0)
    np.testing.assert_array_equal(
        space_to_depth(torch.from_numpy(x), 2).numpy(), np.asarray(jax_space_to_depth(jnp.asarray(x), 2))
    )
    w7 = _input((7, 7, 3, 64), seed=1)
    np.testing.assert_array_equal(s2d_stem_kernel(torch.from_numpy(w7)).numpy(), jax_s2d_stem_kernel(w7))


@pytest.mark.parametrize("stem_s2d", [False, True], ids=["conv1", "conv1_s2d"])
def test_fold_matches_jax(stem_s2d):
    _, variables, port = _pair(stem_s2d, seed=2)
    want = jax_fold(variables["params"], variables["batch_stats"])
    got = port_kernel.fold_stem_params(port)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("stem_s2d", [False, True], ids=["conv1", "conv1_s2d"])
def test_plain_matches_pallas_interpret(stem_s2d):
    _, variables, port = _pair(stem_s2d, seed=3)
    x = _input((2, 64, 64, 3), seed=4)
    want = np.asarray(
        jax_fused_stem(jnp.asarray(x), jax_fold(variables["params"], variables["batch_stats"]),
                       interpret=True)
    )
    got = port_kernel.fused_stem(torch.from_numpy(x), port_kernel.fold_stem_params(port)).numpy()
    assert got.shape == want.shape == (2, 16, 16, 64)
    assert max_rel_err(got, want) < 1e-4


@pytest.mark.parametrize("shape", [(2, 64, 64, 3), (1, 67, 45, 3)], ids=["64x64", "67x45"])
def test_plain_matches_the_standard_stem(shape):
    """Against the JAX conv 7x7/2 -> BN -> ReLU -> maxpool, whose conv takes
    any size: at an odd size the plain version's added zero row and column
    must leave the result unchanged.  The module stem of the port's ResNet
    (train-mode code, eval-mode BN) gives the same."""
    stem = StandardStem()
    x = _input(shape, seed=5)
    variables = perturb_bn(stem.init(jax.random.PRNGKey(6), jnp.asarray(x)), 7)
    want = np.asarray(stem.apply(variables, jnp.asarray(x)))

    port = ResNet101(layers=REDUCED)
    missing, unexpected = port.load_state_dict(state_dict_from_jax(variables), strict=False)
    assert not unexpected and not any(k.startswith(("conv1.", "bn1.")) for k in missing)
    port.eval()
    xt = torch.from_numpy(x)
    got = port_kernel.fused_stem(xt, port_kernel.fold_stem_params(port)).numpy()
    h, w = -(-shape[1] // 4), -(-shape[2] // 4)
    assert got.shape == want.shape == (shape[0], h, w, 64)
    assert max_rel_err(got, want) < 1e-4
    with torch.no_grad():
        modules = port.stem_modules(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert max_rel_err(got, modules) < 1e-4


def test_bf16_rounds_once_at_the_output():
    """bf16: products of bf16 operands in f32, scale, bias, ReLU and pool in
    f32, one rounding at the output (the Pallas kernel's points)."""
    _, _, port = _pair(False, seed=8)
    folded = port_kernel.fold_stem_params(port)
    x = torch.from_numpy(_input((1, 32, 32, 3), seed=9)).bfloat16()
    got = port_kernel.fused_stem(x, folded)
    w_bf16 = {**folded, "w4": folded["w4"].bfloat16().float()}
    want = port_kernel.fused_stem_reference(x.float(), w_bf16).bfloat16()
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("stem_s2d", [False, True], ids=["conv1", "conv1_s2d"])
def test_resnet_matches_jax_in_eval_and_train(stem_s2d):
    """The port's ResNet101(stem_s2d=) against the JAX ResNet101 at reduced
    depth (tests/test_stem_s2d.py:29-50): eval mode through the fused stem,
    train mode through the modules, with the running statistics updated."""
    jnet, variables, port = _pair(stem_s2d, seed=10)
    x = _input((2, 64, 64, 3), seed=11)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    want = jnet.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port(xt)
    for g, w in zip(got, want):
        assert max_rel_err(g.permute(0, 2, 3, 1).numpy(), np.asarray(w)) < 1e-4

    (feats, low), updates = jnet.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    port.train()
    with torch.no_grad():
        got = port(xt)
    for g, w in zip(got, (feats, low)):
        assert max_rel_err(g.permute(0, 2, 3, 1).numpy(), np.asarray(w)) < 1e-4
    stats = jax.device_get(updates["batch_stats"])["bn1"]
    np.testing.assert_allclose(port.bn1.running_mean.numpy(), stats["running_mean"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(port.bn1.running_var.numpy(), stats["running_var"], rtol=1e-4, atol=1e-6)


def test_eval_takes_the_kernel_and_train_the_modules(monkeypatch):
    """Eval mode calls ``ResNet101.stem`` on the NHWC view and the folded
    weights; train mode, and ``freeze_bn`` training (the ResNet stays in
    train mode, only its BN modules go to eval), never do, and keep the
    autograd path to the stem's weights."""
    calls = []

    def recording_stem(x, folded):
        calls.append(tuple(x.shape))
        return port_kernel.fused_stem_reference(x, folded)

    model = build_model(ModelConfig(freeze_bn=True), layers=REDUCED)
    load_numpy_state_dict(model, random_state_dict(model, seed=12))
    monkeypatch.setattr(model.backbone, "stem", recording_stem)
    x = torch.from_numpy(_input((2, 3, 32, 32), seed=13))
    model.eval()
    with torch.no_grad():
        model(x)
    assert calls == [(2, 32, 32, 3)]

    model.train()
    assert model.backbone.training and not model.backbone.bn1.training
    model(x).square().mean().backward()
    assert calls == [(2, 32, 32, 3)]
    g = model.backbone.conv1.weight.grad
    assert g is not None and g.abs().sum() > 0
    assert model.backbone.bn1.weight.grad.abs().sum() > 0


def test_folded_stem_follows_weight_changes():
    """The eval forward refolds after a weight or BN statistic changes in
    place, and keeps its cache otherwise."""
    _, _, port = _pair(False, seed=14)
    x = torch.from_numpy(_input((1, 3, 32, 32), seed=15))
    with torch.no_grad():
        before = port(x)[1]
        cached = port._folded
        port(x)
        assert port._folded is cached
        port.bn1.running_var.mul_(1.5)
        after = port(x)[1]
        port.conv1.weight.add_(0.01)
        after_w = port(x)[1]
    assert not torch.equal(before, after) and not torch.equal(after, after_w)
    fresh = ResNet101(layers=REDUCED)
    fresh.load_state_dict(port.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(after_w, fresh.eval()(x)[1], rtol=0, atol=0)


def test_cpu_tensor_takes_the_plain_version_and_counts_nothing():
    _, _, port = _pair(False, seed=16)
    folded = port_kernel.fold_stem_params(port)
    x = torch.from_numpy(_input((1, 16, 16, 3), seed=17))
    before = port_kernel.fused_stem.launches
    got = port_kernel.fused_stem(x, folded)
    assert port_kernel.fused_stem.launches == before
    torch.testing.assert_close(got, port_kernel.fused_stem_reference(x, folded), rtol=0, atol=0)


def test_wrapper_checks_reject_bad_inputs():
    _, _, port = _pair(False, seed=18)
    folded = port_kernel.fold_stem_params(port)
    port_kernel._check(torch.zeros(1, 9, 7, 3), folded)
    bad = [
        (torch.zeros(1, 8, 8, 4), ValueError),  # four channels
        (torch.zeros(8, 8, 3), ValueError),  # no batch dim
        (torch.zeros(1, 8, 8, 3, dtype=torch.float16), TypeError),
        (torch.zeros(1, 3, 8, 8).permute(0, 2, 3, 1), ValueError),  # not contiguous
    ]
    for x, err in bad:
        with pytest.raises(err):
            port_kernel._check(x, folded)
    with pytest.raises(ValueError):
        port_kernel._check(torch.zeros(1, 8, 8, 3), {**folded, "w4": folded["w4"][:147]})


@pytest.mark.parametrize("stem_s2d", [False, True], ids=["conv1", "conv1_s2d"])
def test_packed_weights_round_trip(stem_s2d):
    """The bf16 kernel's weights: (16 taps, 16, 64), row (dy*2 + dx)*3 + c
    of tap ti*4 + tj as in w4, rows 12-15 zero; unpacking gives w4 back."""
    _, _, port = _pair(stem_s2d, seed=19)
    w4 = port_kernel.fold_stem_params(port)["w4"]
    packed = port_kernel.pack_stem_weights(w4)
    assert packed.shape == (16, 16, 64)
    assert not packed[:, 12:].any()
    for tap in (0, 5, 15):
        torch.testing.assert_close(packed[tap, :12], w4[tap * 12:(tap + 1) * 12], rtol=0, atol=0)
    torch.testing.assert_close(packed[:, :12].reshape(192, 64), w4, rtol=0, atol=0)  # unpacked
    cast = port_kernel.cast_folded(port_kernel.fold_stem_params(port), torch.bfloat16)
    torch.testing.assert_close(cast["w16"], port_kernel.pack_stem_weights(cast["w4"]), rtol=0, atol=0)
    assert port_kernel.cast_folded(cast, torch.bfloat16)["w16"] is cast["w16"]
    assert "w16" not in port_kernel.cast_folded(cast, torch.float32)


def _kernel_index_map_stem(x, folded):
    """The bf16 kernel's arithmetic in f32, following its index map: the
    space-to-depth(2) input of 16 channels ((dy*2 + dx)*3 + c, then 4
    zeros), conv output (r, q) taking tap (ti, tj) from s2d pixel
    (r + ti - 2, q + tj - 2) (0 outside) as one k16 step against the packed
    weights; scale, bias, ReLU; conv outputs outside the image 0 and the
    3x3/2 pool starting from 0."""
    b, h, w, _ = x.shape
    hc, wc = (h + 1) // 2, (w + 1) // 2
    xp = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
    s2d = xp.reshape(b, hc, 2, wc, 2, 3).permute(0, 1, 3, 2, 4, 5).reshape(b, hc, wc, 12)
    s2d = F.pad(s2d, (0, 4, 2, 1, 2, 1))
    taps = torch.stack([s2d[:, ti:ti + hc, tj:tj + wc] for ti in range(4) for tj in range(4)], dim=3)
    conv = torch.einsum("bhwtk,tkn->bhwn", taps, port_kernel.pack_stem_weights(folded["w4"]))
    act = torch.relu(conv * folded["scale"] + folded["bias"]).permute(0, 3, 1, 2)
    pooled = F.max_pool2d(F.pad(act, (1, 1, 1, 1)), 3, 2)
    return pooled.permute(0, 2, 3, 1)


@pytest.mark.parametrize("shape", [(1, 368, 368), (2, 128, 128), (2, 67, 45)],
                         ids=["368", "128", "67x45"])
def test_kernel_index_map_matches_plain(shape):
    _, _, port = _pair(False, seed=20)
    folded = port_kernel.fold_stem_params(port)
    x = torch.from_numpy(_input((*shape, 3), seed=21))
    got = _kernel_index_map_stem(x, folded)
    want = port_kernel.fused_stem_reference(x, folded)
    assert got.shape == want.shape
    assert max_rel_err(got.numpy(), want.numpy()) < 1e-6
