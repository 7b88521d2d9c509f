"""The port's video train step against itself, on the CPU (no JAX step to
compile: a worker of its own): the video loss is the sum of the per-frame
MSEs, and ``remat_tower`` / ``remat_scan`` leave the step as the plain path
computes it (the same loss and gradients; the BN running statistics and
``num_batches_tracked`` updated once a step), and run only in training.
Reduced depth (1, 1, 1, 1), f32, Penn Action's 13 joints, 32x32; the
helpers are tests/test_torch_video_train.py's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_video_train import CONFIG, clip_batch, port_state, port_weights, specs, torch_batch
from torch_parity import max_rel_err, two_threads  # noqa: F401
from unipose_tpu_torch.train import steps

pytestmark = pytest.mark.usefixtures("two_threads")


def test_video_loss_is_t_times_the_mean_over_frames():
    """The fused video loss is ``heatmap_mse`` over the (B*T) flattening
    times T: the sum of the per-frame MSEs (uniposeLSTM.py:124-128).  BN is
    frozen (``freeze_bn``) and dropout off, so the train step's forward is
    the eval forward."""
    spec, _ = specs(32)
    batch = torch_batch(clip_batch(12, 1, 3, 32))
    state = port_state(None, dataclasses.replace(CONFIG, freeze_bn=True), weights=port_weights(3))
    with torch.no_grad():
        out, _ = steps.forward_video_nhwc(state.model.eval(), batch["frames"], batch["centers"], spec)
        targets = steps.make_targets(batch["kpts"], spec)
        per_frame = sum(steps.mse(out[:, t], targets[:, t]) for t in range(3))
    loss = steps.make_train_step(state.model, state.optimizer, spec, video=True,
                                 fused_loss=True)(state, batch)["loss"]
    np.testing.assert_allclose(loss.item(), per_frame.item(), rtol=1e-5)


def _remat_step(weights, config, batch, spec):
    """One video train step (materialised targets) of a port state with
    ``config``'s remat flags: (loss, gradients, BN buffers)."""
    state = port_state(None, config, weights=weights)
    loss = steps.make_train_step(state.model, state.optimizer, spec, video=True)(
        state, torch_batch(batch))["loss"].item()
    buffers = {k: v.clone() for k, v in state.model.state_dict().items()
               if k.rsplit(".", 1)[-1] in ("running_mean", "running_var", "num_batches_tracked")}
    return loss, {n: p.grad.clone() for n, p in state.model.named_parameters()}, buffers


@pytest.mark.parametrize("flags", [{"remat_tower": True}, {"remat_scan": True},
                                   {"remat_tower": True, "remat_scan": True}],
                         ids=["remat_tower", "remat_scan", "both"])
def test_remat_matches_the_plain_path(flags):
    """Twin of tests/test_train.py::test_remat_tower_grad_equivalence: the
    loss and the gradients with rematerialisation equal the plain path's
    (JAX holds them at 1e-3 relative, as a recompute may round in another
    order; the port's recompute runs the same kernels and is held at 1e-6),
    and the BN running statistics and ``num_batches_tracked`` after one
    step equal the plain path's: the recompute left them as the first pass
    did, so they were updated once (every ``num_batches_tracked`` is 1)."""
    spec, _ = specs(32)
    weights = port_weights(5)
    batch = clip_batch(14, 1, 3, 32)
    l0, g0, s0 = _remat_step(weights, CONFIG, batch, spec)
    l1, g1, s1 = _remat_step(weights, dataclasses.replace(CONFIG, **flags), batch, spec)
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    for n in g0:
        assert max_rel_err(g1[n].numpy(), g0[n].numpy()) < 1e-6, n
    assert sorted(s0) == sorted(s1)
    for n, v in s0.items():
        if n.endswith("num_batches_tracked"):
            assert v.item() == s1[n].item() == 1, n
        else:
            assert max_rel_err(s1[n].numpy(), v.numpy()) < 1e-5, n


def test_remat_is_training_only(monkeypatch):
    """Checkpoint segments run only in train mode under autograd: one a
    bottleneck (six at reduced depth: layer4 has three) and one a frame
    after the first; eval mode and train mode without autograd run none.
    With them the forward keeps fewer tensors for the backward."""
    spec, _ = specs(32)
    weights = port_weights(6)
    batch = torch_batch(clip_batch(15, 1, 3, 32))
    segments = [0]
    checkpoint = torch.utils.checkpoint.checkpoint

    def counted(*args, **kwargs):
        segments[0] += 1
        return checkpoint(*args, **kwargs)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counted)

    def forward(config, train, grad=True):
        state = port_state(None, config, weights=weights)
        state.model.train(train)
        segments[0], saved = 0, [0]

        def pack(t):
            saved[0] += 1
            return t

        with torch.set_grad_enabled(grad), torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            steps.forward_video_nhwc(state.model, batch["frames"], batch["centers"], spec)
        return segments[0], saved[0]

    remat = dataclasses.replace(CONFIG, remat_tower=True, remat_scan=True)
    (n_remat, saved_remat), (n_plain, saved_plain) = forward(remat, True), forward(CONFIG, True)
    assert n_remat == 6 + 2 and n_plain == 0
    assert saved_remat < saved_plain
    assert forward(remat, train=False)[0] == 0
    assert forward(remat, train=True, grad=False)[0] == 0
