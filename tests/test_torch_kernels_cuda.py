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

from unipose_tpu_torch.compat import export as artifact
from unipose_tpu_torch.core.config import ModelConfig
from unipose_tpu_torch.models.unipose import (
    build_model,
    load_numpy_state_dict,
    random_state_dict,
)
from unipose_tpu_torch.models import quantized
from unipose_tpu_torch.models.resnet import ResNet101
from unipose_tpu_torch.models.wasp import WASP
from unipose_tpu_torch.ops import kernels
from unipose_tpu_torch.ops.kernels import conv_i8 as ci8
from unipose_tpu_torch.ops.kernels import fused_stem as fs
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


def _folded(seed, dev, dtype, gap_batchnorm=True):
    wasp = WASP(gap_batchnorm=gap_batchnorm)
    load_numpy_state_dict(wasp, random_state_dict(wasp, seed=seed))
    return wc.cast_folded({k: v.to(dev) for k, v in wc.fold_wasp_params(wasp).items()}, dtype)


def test_launch_counts_reset():
    wc.wasp_cascade.launches = 5
    assert kernels.launch_counts()["wasp_cascade"] == 5
    kernels.reset_launches()
    assert kernels.launch_counts() == {
        "wasp_cascade": 0, "heatmap_mse": 0, "heatmap_mse_backward": 0, "fused_stem": 0, "conv_i8": 0,
        "conv_i8_requant": 0,
    }


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,dilations", [(23, (18, 12, 6)), (46, (36, 24, 12)), (8, (18, 12, 6))])
@pytest.mark.parametrize("b", [1, 3, 32])
def test_wasp_cascade_matches_plain(cuda, dtype, s, dilations, b):
    """Batch 1 and 3 split the bf16 K loops, batch 32 at S >= 23 does not;
    two calls give the same bits (the split-K sum has a fixed order)."""
    folded = _folded(11, cuda, dtype)
    gen = torch.Generator(device=cuda).manual_seed(s * 10 + b)
    x = (torch.rand(b, s, s, 2048, generator=gen, device=cuda) * 0.5).to(dtype)
    before = wc.wasp_cascade.launches
    got = wc.wasp_cascade(x, folded, dilations)
    again = wc.wasp_cascade(x, folded, dilations)
    torch.cuda.synchronize()
    assert wc.wasp_cascade.launches == before + 2
    assert got.dtype == dtype and got.shape == (b, s, s, 256)
    assert torch.equal(got, again)
    want = wc.wasp_cascade_reference(x, folded, dilations)
    assert _max_rel_err(got, want) < TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [5, 20, 40])
def test_video_wasp_cascade_matches_plain(cuda, dtype, b):
    """The video WASP (no BN in its GAP branch) at 368x368 OS16 and the
    video paths' batches: a 5-frame chunk (split K slices in bf16), a
    20-frame rollout, a validation batch of 8 five-frame clips."""
    folded = _folded(13, cuda, dtype, gap_batchnorm=False)
    gen = torch.Generator(device=cuda).manual_seed(b)
    x = (torch.rand(b, 23, 23, 2048, generator=gen, device=cuda) * 0.5).to(dtype)
    got = wc.wasp_cascade(x, folded, (18, 12, 6))
    assert torch.equal(got, wc.wasp_cascade(x, folded, (18, 12, 6)))
    assert _max_rel_err(got, wc.wasp_cascade_reference(x, folded, (18, 12, 6))) < TOL[dtype]


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
        before = (wc.wasp_cascade.launches, fs.fused_stem.launches)
        got = model(x.to(cuda))
        torch.cuda.synchronize()
    assert (wc.wasp_cascade.launches, fs.fused_stem.launches) == (before[0] + 1, before[1] + 1)
    assert _max_rel_err(got, want) < 1e-4


def _stem_folded(stem_s2d, seed, dev):
    net = ResNet101(layers=(1, 1, 1, 1), stem_s2d=stem_s2d)
    load_numpy_state_dict(net, random_state_dict(net, seed=seed))
    return {k: v.to(dev) for k, v in fs.fold_stem_params(net).items()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 368, 368), (32, 368, 368), (3, 128, 128), (2, 67, 45)])
@pytest.mark.parametrize("stem_s2d", [False, True], ids=["conv1", "conv1_s2d"])
def test_fused_stem_matches_plain(cuda, dtype, shape, stem_s2d):
    """At the model's size (batch 1 and 32), a small one and an odd one
    whose pooled size is no multiple of the 8x8 tile, with 7x7 weights
    (zero taps skipped in f32) and s2d weights (all 192 taps); two calls
    give the same bits."""
    folded = fs.cast_folded(_stem_folded(stem_s2d, 20, cuda), dtype)
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = (torch.rand(*shape, 3, generator=gen, device=cuda) - 0.5).to(dtype)
    before = fs.fused_stem.launches
    got = fs.fused_stem(x, folded)
    again = fs.fused_stem(x, folded)
    torch.cuda.synchronize()
    assert fs.fused_stem.launches == before + 2
    b, h, w = shape
    assert got.dtype == dtype and got.shape == (b, -(-h // 4), -(-w // 4), 64)
    assert torch.equal(got, again)
    assert _max_rel_err(got, fs.fused_stem_reference(x, folded)) < TOL[dtype]


@pytest.mark.cuda
def test_bf16_kernels_fit_two_blocks_an_sm(cuda):
    """The tensor-core kernels' shared memory and registers leave room for
    at least two resident blocks an SM."""
    assert fs.blocks_per_sm(torch.bfloat16) >= 2
    assert wc.blocks_per_sm() >= 2


@pytest.mark.cuda
def test_fused_stem_raises_on_what_it_does_not_take(cuda):
    folded = _stem_folded(False, 21, cuda)
    with pytest.raises(TypeError):
        fs.fused_stem(torch.zeros(1, 16, 16, 3, device=cuda, dtype=torch.float16), folded)
    with pytest.raises(ValueError):  # an NCHW tensor viewed as NHWC: not contiguous
        fs.fused_stem(torch.zeros(1, 3, 16, 16, device=cuda).permute(0, 2, 3, 1), folded)
    with pytest.raises(ValueError):
        fs.fused_stem(torch.zeros(1, 16, 16, 3, device=cuda), {**folded, "w4": folded["w4"].cpu()})


@pytest.mark.cuda
def test_video_model_on_card_matches_cpu(cuda):
    """A reduced-depth UniPoseLSTM's f32 forward on the card (one fused_stem
    and one wasp_cascade launch for the chunk's frames) against the CPU."""
    from unipose_tpu_torch.core.config import ModelConfig

    model = build_model(ModelConfig(num_classes=13, variant="lstm"), layers=(1, 1, 1, 1)).eval()
    load_numpy_state_dict(model, random_state_dict(model, seed=22))
    rng = np.random.RandomState(23)
    x = torch.from_numpy(rng.rand(1, 3, 3, 128, 128).astype(np.float32) - 0.5)
    cm = torch.from_numpy(rng.rand(1, 3, 1, 128, 128).astype(np.float32))
    with torch.no_grad():
        want, _ = model(x, cm)
        model = model.to(cuda, memory_format=torch.channels_last)
        before = (wc.wasp_cascade.launches, fs.fused_stem.launches)
        got, _ = model(x.to(cuda), cm.to(cuda))
        torch.cuda.synchronize()
    assert (wc.wasp_cascade.launches, fs.fused_stem.launches) == (before[0] + 1, before[1] + 1)
    assert _max_rel_err(got, want) < 1e-4


def _heatmap_inputs(dev, b, k, dtype, seed, h=46, w=46):
    rng = np.random.RandomState(seed)
    pred = torch.from_numpy(rng.randn(b, h, w, k + 1).astype(np.float32)).to(dev, dtype)
    kpts = rng.uniform(-40, 8 * max(h, w) + 40, (b, k, 2)).astype(np.float32)
    kpts[0, :3] = ((-20.0, 10.0), (9000.0, 9000.0), (100.3, 200.9))
    return pred, torch.from_numpy(kpts).to(dev)


def _with_visibility(kpts):
    """(B, K, 3) keypoints, as the batch holds them; [..., :2] is a strided view."""
    return torch.cat([kpts, torch.full_like(kpts[..., :1], 7.0)], dim=-1)


# bf16: the kernel and the plain version compute in f32 from the same bf16
# values and round dpred once; an expf that differs in its last bit can flip
# that rounding by one bf16 ulp (2^-8 relative).  f32: sum order only.
HM_GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _check_heatmap_mse(pred, kpts, sigma=3.0):
    """Loss and gradient through the kernels (one launch each) against the
    plain versions: loss 1e-5 relative, the gradient HM_GRAD_TOL."""
    p = pred.clone().requires_grad_()
    before = (hm.heatmap_mse.launches, hm.heatmap_mse_backward.launches)
    loss = hm.heatmap_mse(p, kpts, 8, sigma)
    loss.backward()
    torch.cuda.synchronize()
    assert (hm.heatmap_mse.launches, hm.heatmap_mse_backward.launches) == (before[0] + 1, before[1] + 1)
    want = hm.heatmap_mse_reference(pred, kpts, 8, sigma)
    assert abs(loss.item() - want.item()) <= 1e-5 * abs(want.item())
    g = torch.ones((), device=pred.device)
    want_grad = hm.heatmap_mse_backward_reference(pred, kpts, g, 8, sigma)
    assert p.grad.dtype == pred.dtype and p.grad.shape == pred.shape
    assert _max_rel_err(p.grad, want_grad) < HM_GRAD_TOL[pred.dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,k,sigma", [(1, 14, 3.0), (8, 14, 3.0), (8, 14, 1.0), (3, 19, 3.0)])
def test_heatmap_mse_matches_plain(cuda, dtype, b, k, sigma):
    pred, kpts = _heatmap_inputs(cuda, b, k, dtype, seed=b * 100 + k)
    _check_heatmap_mse(pred, kpts, sigma)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w", [(45, 37), (16, 16), (8, 8)])
@pytest.mark.parametrize("k", [13, 16, 19, 7])
def test_heatmap_mse_matches_plain_at_batch_32(cuda, dtype, h, w, k):
    """Penn Action, MPII, NTID and (the generic width) BBC joints at odd
    and small heatmaps, whose tiles cross image boundaries."""
    pred, kpts = _heatmap_inputs(cuda, 32, k, dtype, seed=h * w + k, h=h, w=w)
    _check_heatmap_mse(pred, kpts, 3.0 if k != 13 else 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 5, 8])
def test_heatmap_mse_generic_width_at_46(cuda, dtype, b):
    """BBC's 7 joints (8 channels) at the 368x368 heatmap size: K has no
    instantiation of its own, so the generic body runs; sigma 1 (video)."""
    pred, kpts = _heatmap_inputs(cuda, b, 7, dtype, seed=700 + b)
    _check_heatmap_mse(pred, _with_visibility(kpts)[..., :2], 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_heatmap_mse_at_the_video_step_shape(cuda, dtype):
    """The video train step's call: a (1, 5) Penn Action clip flattened to
    (5, 46, 46, 14), sigma 1, the keypoints the strided view of the clip's
    (1, 5, 13, 3) rows reshaped to (5, 13, 3)[..., :2], read in place."""
    rng = np.random.RandomState(41)
    pred = torch.from_numpy(rng.randn(5, 46, 46, 14).astype(np.float32)).to(cuda, dtype)
    clip = np.concatenate([rng.uniform(0, 368, (1, 5, 13, 2)), np.ones((1, 5, 13, 1))], -1)
    rows = torch.from_numpy(clip.astype(np.float32)).to(cuda)
    view = rows.reshape(5, 13, 3)[..., :2]
    assert not view.is_contiguous() and view.data_ptr() == rows.data_ptr()
    _check_heatmap_mse(pred, view, 1.0)
    g = torch.tensor(0.5, device=cuda)
    assert torch.equal(hm.heatmap_mse(pred, view, 8, 1.0), hm.heatmap_mse(pred, view.contiguous(), 8, 1.0))
    assert torch.equal(hm.heatmap_mse_backward(pred, view, g, 8, 1.0),
                       hm.heatmap_mse_backward(pred, view.contiguous(), g, 8, 1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,h,w", [(torch.bfloat16, 46, 46), (torch.float32, 45, 37)])
def test_heatmap_mse_reads_a_misaligned_batch_slice(cuda, dtype, h, w):
    """pred[1:] starts 8 (bf16, 46x46) or 12 (f32, 45x37) bytes off a
    16-byte boundary: the kernels peel its head and tail with scalar
    accesses."""
    full, kpts = _heatmap_inputs(cuda, 9, 14, dtype, seed=31, h=h, w=w)
    pred = full[1:]
    assert pred.data_ptr() % 16 == (8 if dtype == torch.bfloat16 else 12) and pred.is_contiguous()
    _check_heatmap_mse(pred, kpts[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_heatmap_mse_reads_strided_keypoints(cuda, dtype):
    """The train step's (B, K, 3)[..., :2] view, read in place: the same
    bits as the contiguous copy."""
    pred, kpts = _heatmap_inputs(cuda, 8, 14, dtype, seed=32)
    view = _with_visibility(kpts)[..., :2]
    assert not view.is_contiguous()
    _check_heatmap_mse(pred, view)
    g = torch.tensor(0.5, device=cuda)
    assert torch.equal(hm.heatmap_mse(pred, view), hm.heatmap_mse(pred, kpts))
    assert torch.equal(hm.heatmap_mse_backward(pred, view, g), hm.heatmap_mse_backward(pred, kpts, g))


@pytest.mark.cuda
def test_heatmap_mse_blocks_that_take_several_tiles(cuda, monkeypatch):
    """On a card of 4 SMs the plan gives each block 17 tiles of batch 32."""
    monkeypatch.setattr(hm, "_num_sms", lambda device: 4)
    assert hm.tile_plan(32, 46, 46, 15, torch.float32, 4).tiles_per_block > 1
    for dtype in (torch.float32, torch.bfloat16):
        pred, kpts = _heatmap_inputs(cuda, 32, 14, dtype, seed=33)
        _check_heatmap_mse(pred, kpts)


def _heatmap_kernels_launched(fn):
    """Names of the heatmap_mse kernels that ran on the card during fn()."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and "heatmap_mse_" in e.name]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_heatmap_mse_is_one_kernel_a_call_each_way(cuda, dtype):
    pred, kpts = _heatmap_inputs(cuda, 8, 14, dtype, seed=34)
    g = torch.tensor(0.5, device=cuda)
    hm.heatmap_mse(pred, kpts)  # built and warm
    hm.heatmap_mse_backward(pred, kpts, g)
    fwd = _heatmap_kernels_launched(lambda: hm.heatmap_mse(pred, kpts))
    bwd = _heatmap_kernels_launched(lambda: hm.heatmap_mse_backward(pred, kpts, g))
    assert len(fwd) == 1 and "heatmap_mse_fwd_kernel" in fwd[0], fwd
    assert len(bwd) == 1 and "heatmap_mse_bwd_kernel" in bwd[0], bwd


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_heatmap_mse_graph_replays_match_eager(cuda, dtype):
    """heatmap_mse(...).backward() captured once in a CUDA graph; three
    replays, each on new pred values copied into the static input, give
    the bits of the eager calls on those values."""
    preds = [_heatmap_inputs(cuda, 8, 14, dtype, seed=35 + i)[0] for i in range(3)]
    _, kpts = _heatmap_inputs(cuda, 8, 14, dtype, seed=35)
    view = _with_visibility(kpts)[..., :2]
    p = preds[0].clone().requires_grad_()

    def step():
        p.grad = None
        loss = hm.heatmap_mse(p, view)
        loss.backward()
        return loss

    eager = []
    for x in preds:
        with torch.no_grad():
            p.copy_(x)
        # detached: a kept autograd graph would hold p's AccumulateGrad node
        # on this stream, and the captured backward would wait on it
        eager.append((step().detach().clone(), p.grad.clone()))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    p.grad = None
    with torch.cuda.graph(graph):
        static_loss = hm.heatmap_mse(p, view)
        static_loss.backward()
    for x, (want_loss, want_grad) in zip(preds, eager):
        with torch.no_grad():
            p.copy_(x)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(static_loss, want_loss)
        assert torch.equal(p.grad, want_grad)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_heatmap_mse_graph_outlives_a_larger_eager_call(cuda, dtype):
    """A forward at batch 8 warmed up eagerly on a stream (its slots made
    there) and captured on it, then an eager forward at batch 32 on that
    stream, whose plan needs more slots, then new tensors that could take
    freed memory: the replays still give the bits of an eager call at batch
    8, and the eager call at 32 those of a fresh one."""
    small, kpts = _heatmap_inputs(cuda, 8, 14, dtype, seed=41)
    big, big_kpts = _heatmap_inputs(cuda, 32, 14, dtype, seed=42)
    want = hm.heatmap_mse(small, kpts).clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        assert torch.equal(hm.heatmap_mse(small, kpts), want)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        static_loss = hm.heatmap_mse(small, kpts)
    with torch.cuda.stream(stream):
        big_loss = hm.heatmap_mse(big, big_kpts).clone()
        litter = [torch.full((4096,), -1, dtype=torch.int64, device=cuda) for _ in range(64)]
        for _ in range(3):
            static_loss.zero_()
            graph.replay()
            stream.synchronize()
            assert torch.equal(static_loss, want)
    assert torch.equal(big_loss, hm.heatmap_mse(big, big_kpts))
    del litter


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_heatmap_mse_is_deterministic(cuda, dtype):
    """Batch 32: 265 tile blocks, whose partial sums the reducer block adds
    in index order; ten calls give one set of bits."""
    pred, kpts = _heatmap_inputs(cuda, 32, 14, dtype, seed=7)
    g = torch.tensor(0.5, device=cuda)
    losses = [hm.heatmap_mse(pred, kpts) for _ in range(10)]
    assert all(torch.equal(losses[0], x) for x in losses[1:])
    assert torch.equal(hm.heatmap_mse_backward(pred, kpts, g), hm.heatmap_mse_backward(pred, kpts, g))


@pytest.mark.cuda
def test_heatmap_mse_raises_on_what_it_does_not_take(cuda):
    pred, kpts = _heatmap_inputs(cuda, 2, 14, torch.float32, seed=8)
    # a strided (B, K, 3)[..., :2] view is read in place, the visibility skipped
    assert torch.equal(hm.heatmap_mse(pred, _with_visibility(kpts)[..., :2]), hm.heatmap_mse(pred, kpts))
    kpts4 = torch.cat([kpts, kpts], dim=-1)
    with pytest.raises(ValueError, match="rows of 2 or 3"):
        hm.heatmap_mse(pred, kpts4[..., :2])  # rows of 4 floats
    with pytest.raises(ValueError, match="rows of 2 or 3"):
        hm.heatmap_mse(pred, kpts.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="contiguous"):
        hm.heatmap_mse(pred.permute(0, 2, 1, 3), kpts)  # an NWHC view
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


@pytest.mark.cuda
def test_video_train_step_through_the_kernel_matches_the_plain_loss(cuda, monkeypatch):
    """One f32 video train step of a reduced-depth UniPose-LSTM (a (1, 3)
    clip at 128x128) through ``fused_loss`` (one forward and one backward
    kernel over the B*T frames) against the same step through materialised
    targets: loss 1e-5, every gradient 1e-4 max-norm relative."""
    import dataclasses

    from unipose_tpu_torch.core.config import DATASETS, TrainConfig
    from unipose_tpu_torch.models.layers import use_dropout_generator
    from unipose_tpu_torch.train.optim import make_optimizer
    from unipose_tpu_torch.train.state import TrainState
    from unipose_tpu_torch.train.steps import make_train_step

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    spec = dataclasses.replace(DATASETS["Penn_Action"], input_size=128, sigma=1.0)
    rng = np.random.RandomState(12)
    batch = {
        "frames": torch.from_numpy((rng.rand(1, 3, 128, 128, 3) * 255).astype(np.float32)).to(cuda),
        "kpts": torch.from_numpy(
            np.concatenate([rng.rand(1, 3, 13, 2) * 128, np.ones((1, 3, 13, 1))], -1).astype(np.float32)
        ).to(cuda),
        "centers": torch.from_numpy((rng.rand(1, 3, 2) * 128).astype(np.float32)).to(cuda),
    }
    config = ModelConfig(dataset="Penn_Action", num_classes=13, variant="lstm")
    runs = []
    for fused in (True, False):
        model = build_model(config, layers=(1, 1, 1, 1))
        load_numpy_state_dict(model, random_state_dict(model, seed=13))
        model = model.to(cuda, memory_format=torch.channels_last)
        gen = torch.Generator(device=cuda).manual_seed(14)
        use_dropout_generator(model, gen)
        optimizer, scheduler = make_optimizer(model.parameters(), TrainConfig())
        state = TrainState(model, optimizer, scheduler, gen)
        before = (hm.heatmap_mse.launches, hm.heatmap_mse_backward.launches)
        loss = make_train_step(model, optimizer, spec, video=True, fused_loss=fused)(state, batch)["loss"]
        torch.cuda.synchronize()
        assert (hm.heatmap_mse.launches, hm.heatmap_mse_backward.launches) == (
            before[0] + int(fused), before[1] + int(fused))
        runs.append((loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}))
    (l_fused, g_fused), (l_plain, g_plain) = runs
    assert abs(l_fused - l_plain) <= 1e-5 * abs(l_plain)
    for name, g in g_plain.items():
        assert _max_rel_err(g_fused[name], g) < 1e-4, name


# ---------------------------------------------------------------------------
# conv_i8 and the registered ops inside exported programs
# ---------------------------------------------------------------------------

# (Cin, Cout, k, stride, padding, H): every distinct conv of the int8 front
# end at 368x368 (conv1; layer1 at 92; layer2's 3x3/2 and downsample from
# 92 to 46, its convs at 46), and misaligned channel counts.
CONV_I8_SHAPES = {
    "conv1 7x7/2": (3, 64, 7, 2, 3, 368),
    "l1 1x1 64-64": (64, 64, 1, 1, 0, 92),
    "l1 3x3 64": (64, 64, 3, 1, 1, 92),
    "l1 1x1 64-256": (64, 256, 1, 1, 0, 92),
    "l1 1x1 256-64": (256, 64, 1, 1, 0, 92),
    "l2 1x1 256-128": (256, 128, 1, 1, 0, 92),
    "l2 3x3/2 128": (128, 128, 3, 2, 1, 92),
    "l2 1x1 128-512": (128, 512, 1, 1, 0, 46),
    "l2 down 1x1/2 256-512": (256, 512, 1, 2, 0, 92),
    "l2 1x1 512-128": (512, 128, 1, 1, 0, 46),
    "l2 3x3 128": (128, 128, 3, 1, 1, 46),
    "misaligned cin 12": (12, 40, 3, 1, 1, 17),
    "misaligned cin 5 dilated": (5, 24, 3, 1, 2, 15),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CONV_I8_SHAPES))
def test_conv_i8_equals_its_plain_version(cuda, name):
    cin, cout, k, stride, padding, h = CONV_I8_SHAPES[name]
    dilation = 2 if "dilated" in name else 1
    g = torch.Generator().manual_seed(sorted(CONV_I8_SHAPES).index(name))
    x = torch.randint(-127, 128, (2, h, h, cin), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (k, k, cin, cout), generator=g, dtype=torch.int8)
    x[0] = 127  # the largest sums the front end can reach
    want = ci8.conv_i8_reference(x, w, stride, padding, dilation)
    packed = ci8.pack_weight(w).to(cuda)
    before = ci8.conv_i8.launches
    got = ci8.conv_i8(x.to(cuda), packed, k, k, stride, padding, dilation)
    again = ci8.conv_i8(x.to(cuda), packed, k, k, stride, padding, dilation)
    torch.cuda.synchronize()
    assert ci8.conv_i8.launches == before + 2
    assert got.dtype == torch.int32 and torch.equal(got, again)
    assert torch.equal(got.cpu(), want)


# The fused op's epilogues, as the front end calls them: (out_scale given,
# residual dtype, dequantised dtype).
CONV_I8_KINDS = {
    "codes": (True, None, None),
    "f32": (False, None, None),
    "codes_res_f32": (True, torch.float32, None),
    "codes_res_i8": (True, torch.int8, None),
    "codes_res_i8_deq_bf16": (True, torch.int8, torch.bfloat16),
    "codes_res_f32_deq_f32": (True, torch.float32, torch.float32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CONV_I8_SHAPES))
def test_conv_i8_requant_equals_its_plain_version(cuda, name):
    """Every epilogue at every front-end shape (and the misaligned ones):
    codes, f32 outputs and dequantised outputs equal the plain version's,
    on the card and on the CPU (true division on both), bit for bit."""
    cin, cout, k, stride, padding, h = CONV_I8_SHAPES[name]
    dilation = 2 if "dilated" in name else 1
    g = torch.Generator().manual_seed(100 + sorted(CONV_I8_SHAPES).index(name))
    x = torch.randint(-127, 128, (2, h, h, cin), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (k, k, cin, cout), generator=g, dtype=torch.int8)
    x[0] = 127
    # acc * scale at O(1): the codes spread over the range and clip
    scale = (torch.rand(cout, generator=g) + 0.5) / (127 * 127 * (k * k * cin) ** 0.5 / 3)
    bias = torch.randn(cout, generator=g)
    ho = ci8.out_size(h, k, stride, padding, dilation)
    packed = ci8.pack_weight(w).to(cuda)
    for kind, (requant, res, deq) in CONV_I8_KINDS.items():
        residual = None
        if res == torch.float32:
            residual = torch.randn(2, ho, ho, cout, generator=g) * 2
        elif res == torch.int8:
            residual = torch.randint(-127, 128, (2, ho, ho, cout), generator=g, dtype=torch.int8)
        out_scale = 4.0 / 127 if requant else None
        args = (stride, padding, dilation, out_scale, residual, 3.0 / 127, deq)
        want = ci8.conv_i8_requant_reference(x, w, scale, bias, *args)
        dev_args = (stride, padding, dilation, out_scale, None if residual is None else residual.to(cuda),
                    3.0 / 127, deq)
        plain = ci8.conv_i8_requant_reference(x.to(cuda), w.to(cuda), scale.to(cuda), bias.to(cuda), *dev_args)
        before = ci8.conv_i8_requant.launches
        got = ci8.conv_i8_requant(x.to(cuda), packed, scale.to(cuda), bias.to(cuda), k, k, *dev_args)
        torch.cuda.synchronize()
        assert ci8.conv_i8_requant.launches == before + 1
        assert len(got) == len(want) == len(plain), kind
        for a, b, c in zip(got, plain, want):
            assert a.dtype == b.dtype == c.dtype, kind
            assert torch.equal(a, b) and torch.equal(a.cpu(), c), kind
        if requant:
            assert int(got[0].max()) == 127, kind


@pytest.mark.cuda
def test_requant_divides_the_same_on_the_card(cuda):
    """requant divides by a 0-dim tensor on the device: the CPU's quotient,
    where a Python-float divisor multiplies by the f32 reciprocal."""
    h = torch.randn(1 << 20, generator=torch.Generator().manual_seed(5)) * 60
    s = 0.0173
    assert torch.equal(ci8.requant(h.to(cuda), s).cpu(), ci8.requant(h, s))
    assert torch.equal((h.to(cuda) / torch.full((), s, device=cuda)).cpu(), h / s)


@pytest.mark.cuda
def test_conv_i8_requant_divides_truly_at_the_ties(cuda):
    """The epilogue's division at the codes' rounding ties ((j + 0.5) * s
    and its neighbouring floats) and at random values: with x and w zero,
    y is the bias, and every code equals the CPU's true division's."""
    s = 0.0173
    ties = (torch.arange(0, 127, dtype=torch.float32) + 0.5) * s
    bits = ties.view(torch.int32)
    vals = torch.cat([ties, (bits + 1).view(torch.float32), (bits - 1).view(torch.float32),
                      torch.rand(2048, generator=torch.Generator().manual_seed(6)) * 140 * s,
                      -torch.rand(64, generator=torch.Generator().manual_seed(7))])
    n = vals.numel()
    w = ci8.pack_weight(torch.zeros(1, 1, 16, n, dtype=torch.int8)).to(cuda)
    x = torch.zeros(2, 3, 3, 16, dtype=torch.int8, device=cuda)
    got = ci8.conv_i8_requant(x, w, torch.ones(n, device=cuda), vals.to(cuda), 1, 1, out_scale=s)[0]
    want = ci8.requant(torch.relu(vals), s)
    assert torch.equal(got.cpu(), want.expand(2, 3, 3, n))


@pytest.mark.cuda
def test_conv_i8_raises_on_what_it_does_not_take(cuda):
    w = ci8.pack_weight(torch.zeros(3, 3, 8, 16, dtype=torch.int8)).to(cuda)
    with pytest.raises(TypeError):
        ci8.conv_i8(torch.zeros(1, 8, 8, 8, device=cuda), w, 3, 3)
    with pytest.raises(ValueError):
        ci8.conv_i8(torch.zeros(1, 8, 8, 8, dtype=torch.int8, device=cuda), w.cpu(), 3, 3)
    with pytest.raises(ValueError):  # not contiguous
        ci8.conv_i8(torch.zeros(1, 8, 8, 8, dtype=torch.int8, device=cuda).permute(0, 2, 1, 3), w, 3, 3)


def _reduced_model(dev, dtype, layers=(1, 1, 1, 1), seed=31):
    model = build_model(ModelConfig(compute_dtype=dtype), layers=layers)
    load_numpy_state_dict(model, random_state_dict(model, seed=seed))
    return model.to(dev, memory_format=torch.channels_last).eval()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_custom_ops_export_save_load_and_run_on_the_card(cuda, dtype):
    """fused_stem and wasp_cascade inside a program exported on the card,
    saved to bytes, loaded and run: the live model's heatmaps, one launch
    of each kernel a call, counted inside the ops."""
    model = _reduced_model(cuda, dtype)
    ep = artifact.load_exported(artifact.export_inference(model, (2, 128, 128, 3), raw_uint8=True))
    x = torch.randint(0, 256, (2, 128, 128, 3), dtype=torch.uint8, device=cuda)
    kernels.reset_launches()
    got = ep.module()(x)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fused_stem"] == 1 and kernels.launch_counts()["wasp_cascade"] == 1
    with torch.no_grad():
        want = model(((x.float() - 128) / 256).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert _max_rel_err(got, want) < (1e-5 if dtype == torch.float32 else TOL[dtype])


@pytest.mark.cuda
def test_int8_artifact_runs_conv_i8_on_the_card(cuda):
    model = _reduced_model(cuda, torch.bfloat16, layers=(3, 4, 1, 1), seed=32)
    g = torch.Generator().manual_seed(0)
    x = ((torch.rand(2, 128, 128, 3, generator=g) * 255 - 128) / 256).to(cuda)
    _, forward = quantized.int8_forward_fn(model, x, dtype=torch.bfloat16)
    ep = artifact.load_exported(artifact.export_inference(model, (2, 128, 128, 3), forward=forward))
    kernels.reset_launches()
    got = ep.module()(x)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["conv_i8_requant"] == 24 and counts["conv_i8"] == 0
    assert counts["wasp_cascade"] == 1 and counts["fused_stem"] == 0
    with torch.no_grad():
        want = forward(x)
    assert _max_rel_err(got, want) < TOL[torch.bfloat16]


@pytest.mark.cuda
def test_an_artifact_exported_on_the_card_is_refused_on_the_cpu(cuda):
    blob = artifact.export_inference(_reduced_model(cuda, torch.float32), (1, 64, 64, 3))
    assert artifact.artifact_meta(blob)["device"].startswith("cuda")
    with pytest.raises(ValueError, match="cannot run on cpu"):
        artifact.load_exported(blob, device="cpu")
