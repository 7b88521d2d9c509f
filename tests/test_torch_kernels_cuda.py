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
    assert kernels.launch_counts() == {"wasp_cascade": 0}


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
