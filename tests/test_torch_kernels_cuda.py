"""The port's CUDA kernels against their plain PyTorch versions, on a card.

This file imports neither jax nor the JAX package, so it also runs on a
machine that has only the port's dependencies.  The tests marked ``cuda``
skip without a card; on one, run them with

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels_cuda.py

(``--noconftest``: tests/conftest.py steers jax, which such a machine lacks).
"""

import numpy as np
import pytest
import torch

from unipose_tpu_torch.core.config import ModelConfig
from unipose_tpu_torch.models.unipose import (
    build_model,
    load_numpy_state_dict,
    random_state_dict,
)
from unipose_tpu_torch.models.wasp import WASP
from unipose_tpu_torch.ops import kernels
from unipose_tpu_torch.ops.kernels import heatmap_mse as hm
from unipose_tpu_torch.ops.kernels import wasp_cascade as wc

# bf16: the kernel and the plain version round the same intermediates to
# bf16, but from sums taken in another order, so a rounding can flip by one
# bf16 ulp (2^-8 relative) and travel down the cascade.  f32: order only.
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _max_rel_err(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _folded(seed, dev, dtype):
    wasp = WASP()
    load_numpy_state_dict(wasp, random_state_dict(wasp, seed=seed))
    return wc.cast_folded({k: v.to(dev) for k, v in wc.fold_wasp_params(wasp).items()}, dtype)


def test_launch_counts_reset():
    wc.wasp_cascade.launches = 5
    assert kernels.launch_counts()["wasp_cascade"] == 5
    kernels.reset_launches()
    assert kernels.launch_counts() == {
        "wasp_cascade": 0, "heatmap_mse": 0, "heatmap_mse_backward": 0,
    }


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,dilations", [(23, (18, 12, 6)), (46, (36, 24, 12)), (8, (18, 12, 6))])
@pytest.mark.parametrize("b", [1, 3])
def test_wasp_cascade_matches_plain(cuda, dtype, s, dilations, b):
    folded = _folded(11, cuda, dtype)
    gen = torch.Generator(device=cuda).manual_seed(s * 10 + b)
    x = (torch.rand(b, s, s, 2048, generator=gen, device=cuda) * 0.5).to(dtype)
    before = wc.wasp_cascade.launches
    got = wc.wasp_cascade(x, folded, dilations)
    torch.cuda.synchronize()
    assert wc.wasp_cascade.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, s, s, 256)
    want = wc.wasp_cascade_reference(x, folded, dilations)
    assert _max_rel_err(got, want) < TOL[dtype]


@pytest.mark.cuda
def test_wasp_cascade_raises_on_what_it_does_not_take(cuda):
    folded = _folded(12, cuda, torch.float32)
    with pytest.raises(TypeError):
        wc.wasp_cascade(torch.zeros(1, 8, 8, 2048, device=cuda, dtype=torch.float16), folded)
    with pytest.raises(ValueError):
        wc.wasp_cascade(torch.zeros(1, 8, 8, 2048, device=cuda), {**folded, "w1": folded["w1"].cpu()})


@pytest.mark.cuda
def test_model_forward_on_card_matches_cpu(cuda):
    """A reduced-depth model's f32 forward on the card (through the kernel)
    against the same model on the CPU (through the plain version)."""
    model = build_model(ModelConfig(), layers=(1, 1, 1, 1)).eval()
    load_numpy_state_dict(model, random_state_dict(model, seed=13))
    x = torch.from_numpy(np.random.RandomState(14).rand(1, 3, 368, 368).astype(np.float32) - 0.5)
    with torch.no_grad():
        want = model(x)
        model = model.to(cuda, memory_format=torch.channels_last)
        before = wc.wasp_cascade.launches
        got = model(x.to(cuda))
        torch.cuda.synchronize()
    assert wc.wasp_cascade.launches == before + 1
    assert _max_rel_err(got, want) < 1e-4


def _heatmap_inputs(dev, b, k, dtype, seed):
    rng = np.random.RandomState(seed)
    pred = torch.from_numpy(rng.randn(b, 46, 46, k + 1).astype(np.float32)).to(dev, dtype)
    kpts = rng.uniform(-40, 408, (b, k, 2)).astype(np.float32)
    kpts[0, :3] = ((-20.0, 10.0), (9000.0, 9000.0), (100.3, 200.9))
    return pred, torch.from_numpy(kpts).to(dev)


# bf16: the kernel and the plain version compute in f32 from the same bf16
# values and round dpred once; an expf that differs in its last bit can flip
# that rounding by one bf16 ulp (2^-8 relative).  f32: sum order only.
HM_GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,k,sigma", [(1, 14, 3.0), (8, 14, 3.0), (8, 14, 1.0), (3, 19, 3.0)])
def test_heatmap_mse_matches_plain(cuda, dtype, b, k, sigma):
    pred, kpts = _heatmap_inputs(cuda, b, k, dtype, seed=b * 100 + k)
    p = pred.clone().requires_grad_()
    before = (hm.heatmap_mse.launches, hm.heatmap_mse_backward.launches)
    loss = hm.heatmap_mse(p, kpts, 8, sigma)
    loss.backward()
    torch.cuda.synchronize()
    assert (hm.heatmap_mse.launches, hm.heatmap_mse_backward.launches) == (before[0] + 1, before[1] + 1)
    want = hm.heatmap_mse_reference(pred, kpts, 8, sigma)
    assert abs(loss.item() - want.item()) <= 1e-5 * abs(want.item())
    g = torch.ones((), device=cuda)
    want_grad = hm.heatmap_mse_backward_reference(pred, kpts, g, 8, sigma)
    assert p.grad.dtype == dtype
    assert _max_rel_err(p.grad, want_grad) < HM_GRAD_TOL[dtype]


@pytest.mark.cuda
def test_heatmap_mse_is_deterministic(cuda):
    pred, kpts = _heatmap_inputs(cuda, 32, 14, torch.float32, seed=7)
    g = torch.tensor(0.5, device=cuda)
    a, b = hm.heatmap_mse(pred, kpts), hm.heatmap_mse(pred, kpts)
    assert torch.equal(a, b)
    assert torch.equal(hm.heatmap_mse_backward(pred, kpts, g), hm.heatmap_mse_backward(pred, kpts, g))


@pytest.mark.cuda
def test_heatmap_mse_raises_on_what_it_does_not_take(cuda):
    pred, kpts = _heatmap_inputs(cuda, 2, 14, torch.float32, seed=8)
    kpts3 = torch.cat([kpts, torch.ones_like(kpts[..., :1])], dim=-1)
    with pytest.raises(ValueError, match="contiguous"):
        hm.heatmap_mse(pred, kpts3[..., :2])  # a strided view of (B, K, 3)
    with pytest.raises(ValueError):
        hm.heatmap_mse(pred, kpts.cpu())
    with pytest.raises(ValueError):
        hm.heatmap_mse(pred[..., :10].contiguous(), kpts)
    with pytest.raises(TypeError):
        hm.heatmap_mse(pred.half(), kpts)


@pytest.mark.cuda
def test_train_step_through_the_kernel_matches_the_plain_loss(cuda, monkeypatch):
    """One f32 train step of a reduced-depth model through ``fused_loss``
    against the same step through materialised targets: loss 1e-5, every
    gradient 1e-4 max-norm relative (the forwards are the same; only the
    loss's last bits differ)."""
    import dataclasses

    from unipose_tpu_torch.core.config import DATASETS, TrainConfig
    from unipose_tpu_torch.models.layers import use_dropout_generator
    from unipose_tpu_torch.train.optim import make_optimizer
    from unipose_tpu_torch.train.state import TrainState
    from unipose_tpu_torch.train.steps import make_train_step

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    spec = dataclasses.replace(DATASETS["LSP"], input_size=128)
    rng = np.random.RandomState(9)
    batch = {
        "image": torch.from_numpy((rng.rand(2, 128, 128, 3) * 255).astype(np.float32)).to(cuda),
        "kpts": torch.from_numpy(
            np.concatenate([rng.rand(2, 14, 2) * 128, np.ones((2, 14, 1))], -1).astype(np.float32)
        ).to(cuda),
    }
    runs = []
    for fused in (True, False):
        model = build_model(ModelConfig(), layers=(1, 1, 1, 1))
        load_numpy_state_dict(model, random_state_dict(model, seed=10))
        model = model.to(cuda, memory_format=torch.channels_last)
        gen = torch.Generator(device=cuda).manual_seed(11)
        use_dropout_generator(model, gen)
        optimizer, scheduler = make_optimizer(model.parameters(), TrainConfig())
        state = TrainState(model, optimizer, scheduler, gen)
        before = hm.heatmap_mse.launches
        loss = make_train_step(model, optimizer, spec, fused_loss=fused)(state, batch)["loss"]
        torch.cuda.synchronize()
        assert hm.heatmap_mse.launches == before + int(fused)
        runs.append((loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}))
    (l_fused, g_fused), (l_plain, g_plain) = runs
    assert abs(l_fused - l_plain) <= 1e-5 * abs(l_plain)
    for name, g in g_plain.items():
        assert _max_rel_err(g_fused[name], g) < 1e-4, name
