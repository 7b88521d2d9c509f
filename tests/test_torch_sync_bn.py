"""The port's TorchBatchNorm against the JAX package's, on the CPU: per-group
statistics (``stat_groups``) in one process, the same through a Bottleneck
and the reduced ResNet-101 (``bn_groups``), statistics across two gloo ranks
(child processes) against ``axis_name``'s global-batch semantics, and the
Trainer's wiring of ``ModelConfig.sync_bn`` with its state init stubbed
(tests/test_sync_bn.py:230).

Tolerance: max-norm relative error < 1e-4 in f32 for outputs, running
statistics and input gradients (the port's parity bar, ROADMAP.md).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import max_rel_err, run_ranks, two_threads_for_the_module  # noqa: F401
from unipose_tpu.models.layers import TorchBatchNorm as JaxBatchNorm
from unipose_tpu.models.resnet import Bottleneck as JaxBottleneck
from unipose_tpu.models.resnet import ResNet101 as JaxResNet101
from unipose_tpu_torch.compat.from_jax import state_dict_from_jax
from unipose_tpu_torch.models.layers import TorchBatchNorm
from unipose_tpu_torch.models.resnet import Bottleneck, ResNet101

TOL = 1e-4
REDUCED = (1, 1, 1, 1)


def _bn_case(seed, b=4, c=6, h=5, w=5):
    rng = np.random.RandomState(seed)
    return {
        "x": (rng.randn(b, c, h, w) * 2 + 0.5).astype(np.float32),
        "r": rng.randn(b, c, h, w).astype(np.float32),
        "weight": (1 + 0.1 * rng.randn(c)).astype(np.float32),
        "bias": (0.05 * rng.randn(c)).astype(np.float32),
    }


def _jax_bn(case, **kw):
    """JAX TorchBatchNorm in train mode on the NHWC batch: output (NCHW),
    running statistics, and the gradient of sum(y * r) in x (NCHW)."""
    bn = JaxBatchNorm(**kw)
    x = jnp.asarray(case["x"].transpose(0, 2, 3, 1))
    r = jnp.asarray(case["r"].transpose(0, 2, 3, 1))
    c = x.shape[-1]
    variables = {
        "params": {"weight": jnp.asarray(case["weight"]), "bias": jnp.asarray(case["bias"])},
        "batch_stats": {"running_mean": jnp.zeros(c), "running_var": jnp.ones(c)},
    }

    def loss(xx):
        y, upd = bn.apply(variables, xx, use_running_average=False, mutable=["batch_stats"])
        return jnp.sum(y * r), (y, upd["batch_stats"])

    (_, (y, stats)), dx = jax.value_and_grad(loss, has_aux=True)(x)
    nchw = lambda a: np.asarray(a).transpose(0, 3, 1, 2)  # noqa: E731
    return {"y": nchw(y), "dx": nchw(dx), "running_mean": np.asarray(stats["running_mean"]),
            "running_var": np.asarray(stats["running_var"])}


def _port_bn(case, stat_groups=1):
    bn = TorchBatchNorm(case["x"].shape[1], stat_groups=stat_groups).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(case["weight"]))
        bn.bias.copy_(torch.from_numpy(case["bias"]))
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    y = bn(x)
    (y * torch.from_numpy(case["r"])).sum().backward()
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(), "running_mean": bn.running_mean.numpy(),
            "running_var": bn.running_var.numpy(), "num_batches_tracked": int(bn.num_batches_tracked)}


def _assert_close(got, want, keys=("y", "dx", "running_mean", "running_var")):
    for k in keys:
        assert max_rel_err(got[k], want[k]) < TOL, (k, max_rel_err(got[k], want[k]))


def test_stat_groups_match_jax():
    """stat_groups=2: output, running statistics and input gradient equal
    JAX's; each group is normalised alone (== plain BN on the group), and
    the running statistics are the whole batch's (== the g=1 update)."""
    case = _bn_case(0)
    got = _port_bn(case, stat_groups=2)
    _assert_close(got, _jax_bn(case, stat_groups=2))
    assert got["num_batches_tracked"] == 1
    halves = [_port_bn({**case, "x": case["x"][i:i + 2], "r": case["r"][i:i + 2]}) for i in (0, 2)]
    np.testing.assert_allclose(got["y"], np.concatenate([h["y"] for h in halves]), rtol=1e-5, atol=1e-5)
    whole = _port_bn(case)
    for k in ("running_mean", "running_var"):
        np.testing.assert_allclose(got[k], whole[k], rtol=1e-5, atol=1e-6)
    assert not np.allclose(got["y"], whole["y"])


def test_stat_groups_keep_the_input_dtype_and_eval_is_plain():
    bn = TorchBatchNorm(3, stat_groups=2).train()
    x = torch.randn(4, 3, 4, 4, generator=torch.Generator().manual_seed(1))
    assert bn(x.bfloat16()).dtype == torch.bfloat16
    assert bn.running_mean.dtype == torch.float32
    bn.eval()
    ref = torch.nn.BatchNorm2d(3)
    ref.load_state_dict(bn.state_dict())
    torch.testing.assert_close(bn(x), ref.eval()(x), rtol=0, atol=0)


def test_stat_groups_need_a_divisible_batch():
    bn = TorchBatchNorm(3, stat_groups=3).train()
    with pytest.raises(ValueError, match="divisible"):
        bn(torch.zeros(4, 3, 2, 2))


def _jax_train_forward(module, variables, x):
    out, upd = module.apply(variables, x, train=True, mutable=["batch_stats"])
    return out, upd["batch_stats"]


def test_bottleneck_bn_groups_match_jax():
    """A Bottleneck (with downsample) with bn_groups=2 against JAX's: the
    train-mode output, every running statistic, and the input gradient."""
    rng = np.random.RandomState(3)
    x = rng.randn(4, 8, 8, 16).astype(np.float32)
    jb = JaxBottleneck(4, has_downsample=True, bn_groups=2)
    variables = jb.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]), train=False)
    r = rng.randn(4, 8, 8, 16).astype(np.float32)

    def loss(xx):
        out, stats = _jax_train_forward(jb, variables, xx)
        return jnp.sum(out * r), (out, stats)

    (_, (want, jstats)), jdx = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(x))
    block = Bottleneck(16, 4, has_downsample=True, bn_groups=2).train()
    block.load_state_dict(state_dict_from_jax(jax.device_get(variables)))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    out = block(xt)
    (out * torch.from_numpy(r.transpose(0, 3, 1, 2).copy())).sum().backward()
    assert max_rel_err(out.detach().numpy(), np.asarray(want).transpose(0, 3, 1, 2)) < TOL
    assert max_rel_err(xt.grad.numpy(), np.asarray(jdx).transpose(0, 3, 1, 2)) < TOL
    want_stats = state_dict_from_jax({"batch_stats": jax.device_get(jstats)})
    for k, v in block.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            assert max_rel_err(v.numpy(), want_stats[k].numpy()) < TOL, k


def test_reduced_resnet_bn_groups_match_jax():
    """The reduced ResNet-101 with bn_groups=2, train mode, 64x64, batch 4:
    both outputs and every running statistic against JAX's; the grouped
    forward differs from the ungrouped one."""
    rng = np.random.RandomState(4)
    x = (rng.rand(4, 64, 64, 3).astype(np.float32) - 0.5)
    jm = JaxResNet101(layers=REDUCED, bn_groups=2)
    variables = jax.jit(lambda k, xx: jm.init(k, xx, train=False))(jax.random.PRNGKey(0), jnp.asarray(x[:1]))
    (jfeats, jlow), jstats = jax.jit(lambda xx: _jax_train_forward(jm, variables, xx))(jnp.asarray(x))
    model = ResNet101(layers=REDUCED, bn_groups=2).train()
    model.load_state_dict(state_dict_from_jax(jax.device_get(variables)))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        feats, low = model(xt)
    assert max_rel_err(feats.numpy(), np.asarray(jfeats).transpose(0, 3, 1, 2)) < TOL
    assert max_rel_err(low.numpy(), np.asarray(jlow).transpose(0, 3, 1, 2)) < TOL
    want_stats = state_dict_from_jax({"batch_stats": jax.device_get(jstats)})
    n = 0
    for k, v in model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            assert max_rel_err(v.numpy(), want_stats[k].numpy()) < TOL, k
            n += 1
    assert n == 2 * 23  # the stem, three one-block stages and layer4 (multi-grid: 3 blocks)
    plain = ResNet101(layers=REDUCED).train()
    plain.load_state_dict(state_dict_from_jax(jax.device_get(variables)))
    with torch.no_grad():
        assert not torch.allclose(plain(xt)[0], feats, atol=1e-3)


@pytest.fixture(scope="module")
def bn_ranks(tmp_path_factory):
    """Two gloo ranks, each with its half of the batch of ``_bn_case(5)``,
    once with global statistics (sync) and once per rank."""
    tmp = tmp_path_factory.mktemp("bn_ranks")
    case = _bn_case(5)
    np.savez(tmp / "x.npz", **case)
    out = {}
    for sync in (True, False):
        d = tmp / f"sync_{sync}"
        d.mkdir()
        out[sync] = run_ranks("bn", {"x": str(tmp / "x.npz"), "sync": sync, "device": "cpu"}, d)
    return case, out


@pytest.mark.parametrize("sync", [True, False], ids=["global_moments", "per_rank_moments"])
def test_bn_across_two_ranks_matches_jax(bn_ranks, sync):
    """Across two ranks: with sync, the ranks' outputs and input gradients,
    concatenated, equal JAX's BatchNorm on the global batch (what
    ``axis_name`` gives under shard_map); per rank, JAX's stat_groups=2.
    Either way each rank's running statistics are the global batch's, and
    the two ranks' buffers are bit-equal."""
    case, out = bn_ranks
    ranks = out[sync]
    got = {k: np.concatenate([r[k].numpy() for r in ranks]) for k in ("y", "dx")}
    want = _jax_bn(case) if sync else _jax_bn(case, stat_groups=2)
    for r in ranks:
        got["running_mean"], got["running_var"] = r["running_mean"].numpy(), r["running_var"].numpy()
        _assert_close(got, want)
        assert int(r["num_batches_tracked"]) == 1
    for k in ("running_mean", "running_var"):
        assert torch.equal(ranks[0][k], ranks[1][k]), k


# ---------------------------------------------------------------------------
# the Trainer's wiring (its state init stubbed, as tests/test_sync_bn.py:230)
# ---------------------------------------------------------------------------


def _stub_trainer_deps(monkeypatch, captured):
    import unipose_tpu_torch.train.trainer as trainer_mod

    model = torch.nn.Conv2d(1, 1, 1)

    class State:
        generator = torch.Generator()
        step = 0

    def fake_create(mc, tc, seed, device=None, bn_groups=1):
        captured["create_bn_groups"] = bn_groups
        return model, None, State()

    monkeypatch.setattr(trainer_mod, "create_train_state", fake_create)
    monkeypatch.setattr(trainer_mod, "make_train_step", lambda m, *a, **k: captured.update(step_model=m))
    monkeypatch.setattr(trainer_mod, "make_val_step", lambda *a, **k: None)
    monkeypatch.setattr(trainer_mod, "set_bn_process_group",
                        lambda m, group, sync: captured.update(bn_sync=sync))
    monkeypatch.setattr(trainer_mod, "use_dropout_generator",
                        lambda m, g, shard=None: captured.update(shard=shard))
    monkeypatch.setattr(trainer_mod, "replicate", lambda m, mesh: captured.update(replicated=True))
    monkeypatch.setattr(trainer_mod, "data_parallel", lambda m, mesh: ("ddp", m))
    return model


def test_trainer_wires_sync_bn(monkeypatch):
    """sync_bn is a real knob: over an 8-rank data mesh, True keeps one
    statistics group and all-reduces the moments, False gives bn_groups 8
    (per-rank moments, pooled running statistics); the step runs on the
    DDP wrapper, the state keeps the bare model; the dropout masks are the
    global batch's rows of rank 0.  The JAX errors: a batch that the shard
    count does not divide, and sync_bn=False with a time axis."""
    from unipose_tpu_torch.core.config import ModelConfig, TrainConfig
    from unipose_tpu_torch.parallel.mesh import make_mesh
    from unipose_tpu_torch.train.trainer import Trainer

    captured = {}
    model = _stub_trainer_deps(monkeypatch, captured)
    mesh = dataclasses.replace(make_mesh((8,), world=8, rank=0), distributed=True)

    t = Trainer(ModelConfig(), TrainConfig(batch_size=16), loaders=(None, None), device="cpu", mesh=mesh)
    assert captured["create_bn_groups"] == 1 and captured["bn_sync"] is True
    assert captured["shard"] == (0, 8) and captured["replicated"]
    assert captured["step_model"] == ("ddp", model) and t.model is model and t.is_main

    Trainer(ModelConfig(sync_bn=False), TrainConfig(batch_size=16), loaders=(None, None),
            device="cpu", mesh=mesh)
    assert captured["create_bn_groups"] == 1 and captured["bn_sync"] is False

    with pytest.raises(ValueError, match="divisible"):
        Trainer(ModelConfig(sync_bn=False), TrainConfig(batch_size=12), loaders=(None, None),
                device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="context parallelism"):
        Trainer(ModelConfig(dataset="Penn_Action", num_classes=13, variant="lstm", sync_bn=False),
                TrainConfig(batch_size=2), loaders=(None, None), device="cpu",
                mesh=make_mesh((2, 4), ("data", "time"), world=8))
    with pytest.raises(ValueError, match="every rank must train"):
        with pytest.warns(UserWarning, match="7 idle"):
            Trainer(ModelConfig(), TrainConfig(batch_size=16), loaders=(None, None), device="cpu",
                    mesh=make_mesh((1,), world=8))

    # one process: no group, no wrapper, one statistics group
    captured.clear()
    Trainer(ModelConfig(sync_bn=False), TrainConfig(batch_size=16), loaders=(None, None), device="cpu")
    assert "bn_sync" not in captured and captured["step_model"] is model


def test_trainer_default_mesh_is_every_rank(monkeypatch):
    """Under a group of 8 ranks the default mesh_shape (1,) is the data
    axis over all 8, in the Trainer itself (no launcher-side rewrite); a
    mesh the config names that leaves ranks out still raises."""
    import unipose_tpu_torch.train.trainer as trainer_mod
    from unipose_tpu_torch.core.config import ModelConfig, TrainConfig
    from unipose_tpu_torch.parallel.mesh import make_mesh
    from unipose_tpu_torch.train.trainer import Trainer

    captured = {}
    _stub_trainer_deps(monkeypatch, captured)
    monkeypatch.setattr(trainer_mod, "make_mesh", lambda shape, axes: dataclasses.replace(
        make_mesh(shape, axes, world=8, rank=3), distributed=True))

    t = Trainer(ModelConfig(), TrainConfig(batch_size=16), loaders=(None, None), device="cpu")
    assert TrainConfig().mesh_shape == (1,)
    assert t.mesh.shape == (8,) and t.mesh.axis_names == ("data",) and not t.is_main
    assert captured["shard"] == (3, 8) and captured["replicated"]
    with pytest.raises(ValueError, match="every rank must train"):
        with pytest.warns(UserWarning, match="6 idle"):
            Trainer(ModelConfig(), TrainConfig(batch_size=16, mesh_shape=(2,)), loaders=(None, None),
                    device="cpu")
