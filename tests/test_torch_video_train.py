"""The port's UniPose-LSTM training path against the JAX package's, on the
CPU: the video train step (loss, every gradient, BN running statistics)
against ``make_train_step(video=True, donate=False)``, through the
``heatmap_mse`` loss over the B*T frames and through materialised targets,
and the video validation and eval steps.  Reduced depth (1, 1, 1, 1), f32,
Penn Action's 13 joints, sigma 1.  The remat paths and the loss's
per-frame sum are held in tests/test_torch_video_remat.py.

Dropout streams cannot match (JAX keys against a torch.Generator), so
dropout is off on both sides: ``p = 0`` in the port and
``flax.linen.Dropout.__call__`` patched to the identity, as
tests/test_torch_train.py does.  Torch's threads are held at 8 there too.

Tolerances, each stated where it is checked: loss 1e-5 relative; each
gradient tensor 1e-4 max-norm relative; BN statistics 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import flax.linen
import jax
import jax.numpy as jnp

from test_torch_train import LR, _jax_state, _stats, fixed_threads  # noqa: F401
from torch_parity import max_rel_err, perturb_bn, reduced_lstm_depth
from unipose_tpu.core.config import DATASETS as JAX_DATASETS
from unipose_tpu.models.unipose_lstm import UniPoseLSTM as JaxUniPoseLSTM
from unipose_tpu.train import steps as jax_steps
from unipose_tpu_torch.compat.from_jax import state_dict_from_jax
from unipose_tpu_torch.core.config import DATASETS, ModelConfig, TrainConfig
from unipose_tpu_torch.models.layers import Dropout
from unipose_tpu_torch.models.unipose import build_model, load_numpy_state_dict, random_state_dict
from unipose_tpu_torch.train import optim, steps
from unipose_tpu_torch.train.state import TrainState

REDUCED = (1, 1, 1, 1)
CONFIG = ModelConfig(dataset="Penn_Action", num_classes=13, variant="lstm")

# The held case: clip batch, frames a clip, input size, weights seed.  The
# readings behind it are in the comment above held_case.
GRAD_B, GRAD_T, GRAD_SIZE, GRAD_SEED = 2, 3, 32, 13


@pytest.fixture(scope="module", autouse=True)
def _reduced_jax_depth():
    with reduced_lstm_depth(REDUCED):
        yield


def specs(size):
    return (dataclasses.replace(DATASETS["Penn_Action"], input_size=size, sigma=1.0),
            dataclasses.replace(JAX_DATASETS["Penn_Action"], input_size=size, sigma=1.0))


def clip_batch(seed, b, t, size, k=13):
    """Seeded raw clips: frames (B, T, H, W, 3) in [0, 255], each a random
    4x4 image upsampled (bicubic) to the frame size, so that features vary
    across a clip as a picture's do (see GRAD_SEED); keypoints (B, T, K, 3)
    inside the frame with visibility 1, centers (B, T, 2)."""
    rng = np.random.RandomState(seed)
    small = rng.rand(b * t, 4, 4, 3) * 255
    frames = np.stack([cv2.resize(f, (size, size), interpolation=cv2.INTER_CUBIC) for f in small])
    return {
        "frames": np.clip(frames, 0, 255).reshape(b, t, size, size, 3).astype(np.float32),
        "kpts": np.concatenate([rng.rand(b, t, k, 2) * size, np.ones((b, t, k, 1))],
                               axis=-1).astype(np.float32),
        "centers": (rng.rand(b, t, 2) * size).astype(np.float32),
    }


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


_JAX_INIT = {}


def jax_variables(seed):
    """The JAX UniPoseLSTM (reduced depth; trace it inside
    ``reduced_lstm_depth``) and its variables, BN perturbed from
    ``seed + 1``.  The init is compiled once a process (parameter shapes do
    not depend on the input's)."""
    if "init" not in _JAX_INIT:
        model = JaxUniPoseLSTM(num_classes=13)
        _JAX_INIT["model"] = model
        _JAX_INIT["init"] = jax.jit(lambda k, f, c: model.init(k, f, c, train=False))
    variables = _JAX_INIT["init"](jax.random.PRNGKey(seed), jnp.zeros((1, 2, 32, 32, 3)),
                                  jnp.zeros((1, 2, 32, 32, 1)))
    return _JAX_INIT["model"], perturb_bn(variables, seed + 1)


def port_state(variables, config=CONFIG, dtype=torch.float32, *, weights=None):
    """The port's LSTM at reduced depth with the JAX weights (or, for the
    tests of the port alone, ``weights``: a numpy state_dict), dropout off,
    Adam at LR."""
    model = build_model(dataclasses.replace(config, compute_dtype=dtype), layers=REDUCED)
    if weights is None:
        model.load_state_dict(state_dict_from_jax(variables, variant="lstm"))
    else:
        load_numpy_state_dict(model, weights)
    model = model.to(dtype).to(memory_format=torch.channels_last)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    optimizer, scheduler = optim.make_optimizer(model.parameters(), TrainConfig(lr=LR))
    return TrainState(model, optimizer, scheduler, torch.Generator().manual_seed(0))


def port_weights(seed):
    """Seeded port weights with randomised BN statistics (no JAX needed)."""
    return random_state_dict(build_model(CONFIG, layers=REDUCED), seed)


def jax_step(model, variables, batch, jspec):
    """JAX's video train step from ``variables``: (loss, gradients and BN
    statistics as the port's state_dict keys)."""
    tx, jstate = _jax_state(variables)
    jstate, metrics = jax_steps.make_train_step(model, tx, jspec, video=True, donate=False)(
        jstate, jax.tree_util.tree_map(jnp.asarray, batch)
    )
    grads = state_dict_from_jax({"params": jstate.opt_state[0]}, variant="lstm")
    stats = state_dict_from_jax({"batch_stats": jstate.batch_stats}, variant="lstm")
    return float(metrics["loss"]), grads, stats


def float64_twin(variables, batch, spec):
    """The port's train-mode forward and backward (materialised targets) in
    f64 from the same weights: {name: gradient}, {name: BN statistic}."""
    state = port_state(variables, dtype=torch.float64)
    b = {k: torch.from_numpy(v).double() for k, v in batch.items()}
    out, _ = steps.forward_video_nhwc(state.model.train(), b["frames"], b["centers"], spec)
    (steps.mse(out, steps.make_targets(b["kpts"], spec)) * out.shape[1]).backward()
    return ({n: p.grad.numpy() for n, p in state.model.named_parameters()},
            {k: v.numpy() for k, v in _stats(state).items()})


# The readings behind the held case (tests/torch_conditioning.py --video
# prints them).  JAX's BatchNorm takes its batch variance as E[x^2] - E[x]^2
# in f32 (unipose_tpu/models/layers.py:80-89, :102-107), which cancels where
# a channel's mean is large against its spread; the port's (PyTorch's)
# does not.  With uniform-noise frames at B 2, T 3, 32x32 no weights seed of
# 44 (0-63 in part) put every gradient within 1e-4 of JAX: at the best,
# JAX's own f32 lay 1.45e-4 from the f64 gradients where the port's lay
# 6.4e-5, every tensor ~1e-4 off, and wasp.bn1.running_var 1.0-2.7e-5
# apart.  Frames that vary as pictures do (clip_batch) spread the features:
# of weights seeds 0-34, 6 put every gradient within 1e-4 of JAX, 3 of
# them every BN statistic within 1e-5 too, and seed 13 does so with the
# widest margins (7.6e-5 and 7.0e-6; the port's f32 5.1e-5 from its f64,
# JAX's 7.4e-5).  At 48x48 and 64x64 (B 1-2) the port's own f32 gradients
# lay 0.1-0.2 from its f64 at each seed read: a ReLU or max flipped by
# rounding, which no f32 pair can be held through.  Six frames a step at
# 32x32 give WASP's BatchNorms 24 values each.
@pytest.fixture(scope="module")
def held_case():
    """The held case's weights, batch and JAX's step on it (computed once:
    JAX has one video loss, which both port losses are held against)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **kw: x)
        jmodel, variables = jax_variables(GRAD_SEED)
        batch = clip_batch(11, GRAD_B, GRAD_T, GRAD_SIZE)
        return variables, batch, jax_step(jmodel, variables, batch, specs(GRAD_SIZE)[1])


@pytest.mark.parametrize("fused", [True, False], ids=["fused_loss", "materialised_targets"])
def test_video_train_step_matches_jax(held_case, fused):
    spec, _ = specs(GRAD_SIZE)
    variables, batch, (jloss, jgrads, jstats) = held_case
    state = port_state(variables)
    metrics = steps.make_train_step(state.model, state.optimizer, spec, video=True,
                                    fused_loss=fused)(state, torch_batch(batch))
    assert state.step == 1 and metrics["loss"].shape == ()
    # loss: relative error 1e-5
    np.testing.assert_allclose(metrics["loss"].item(), jloss, rtol=1e-5)
    # every parameter's gradient: max-norm relative error 1e-4
    named = dict(state.model.named_parameters())
    assert sorted(named) == sorted(jgrads)
    for name, p in named.items():
        assert max_rel_err(p.grad.numpy(), jgrads[name].numpy()) < 1e-4, name
    # BN running statistics after the step: max-norm relative error 1e-5
    for name, v in _stats(state).items():
        assert max_rel_err(v.numpy(), jstats[name].numpy()) < 1e-5, name


def test_video_train_step_against_its_float64_twin(held_case):
    """At the held case the port's f32 step lies within 1e-4 of its own f64
    twin in every gradient and within 1e-5 in every BN statistic: the case
    is conditioned well enough for the parity above to mean something.
    And its gradients lie no farther from that twin than JAX's f32 step's
    do (5.1e-5 against 7.4e-5 at the held case), so that should a later
    change of reduction order flip the parity above, this test tells JAX's
    rounding from a fault of the port."""
    spec, _ = specs(GRAD_SIZE)
    variables, batch, (_, jgrads, _) = held_case
    state = port_state(variables)
    steps.make_train_step(state.model, state.optimizer, spec, video=True)(state, torch_batch(batch))
    grads64, stats64 = float64_twin(variables, batch, spec)
    for n, p in state.model.named_parameters():
        assert max_rel_err(p.grad.numpy(), grads64[n]) < 1e-4, n
    for n, v in _stats(state).items():
        assert max_rel_err(v.numpy(), stats64[n]) < 1e-5, n
    port_gap = max(max_rel_err(p.grad.numpy(), grads64[n]) for n, p in state.model.named_parameters())
    jax_gap = max(max_rel_err(jgrads[n].numpy(), g) for n, g in grads64.items())
    assert port_gap <= jax_gap, (port_gap, jax_gap)


# ---------------------------------------------------------------------------
# validation and eval steps
# ---------------------------------------------------------------------------


def test_video_val_and_eval_steps_match_jax():
    """Equal coordinates (B, T, K+1, 2), the loss within 1e-5 relative, the
    heatmaps within 1e-4 max-norm relative."""
    spec, jspec = specs(64)
    jmodel, variables = jax_variables(4)
    batch = clip_batch(13, 2, 3, 64)
    state = port_state(variables)
    pred, tgt, loss = steps.make_val_step(state.model, spec, video=True)(torch_batch(batch))
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    jpred, jtgt, jloss = jax_steps.make_val_step(jmodel, jspec, video=True)(
        variables["params"], variables["batch_stats"], jbatch
    )
    assert state.model.training  # the step restores the mode it found
    assert pred.shape == tgt.shape == (2, 3, 14, 2)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(jpred))
    np.testing.assert_array_equal(tgt.numpy(), np.asarray(jtgt))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)

    heat, targets, eloss = steps.make_eval_step(state.model, spec, video=True)(torch_batch(batch))
    jheat, jtargets, jeloss = jax_steps.make_eval_step(jmodel, jspec, video=True)(
        variables["params"], variables["batch_stats"], jbatch
    )
    assert heat.shape == targets.shape == (2, 3, 8, 8, 14)
    assert max_rel_err(heat.numpy(), np.asarray(jheat)) < 1e-4
    np.testing.assert_allclose(targets.numpy(), np.asarray(jtargets), rtol=0, atol=1e-6)
    np.testing.assert_allclose(eloss.item(), float(jeloss), rtol=1e-5)
    assert eloss.item() == loss.item()
