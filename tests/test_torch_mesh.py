"""The port's parallel/mesh.py: ``maybe_init_distributed`` (monkeypatched:
no process group is made here), ``make_mesh`` against the JAX package's
(-1 resolution, the stranded-device errors of tests/test_mesh.py:97,181),
``shard_batch`` against the rows JAX's ``shard_batch`` puts on each device
of a data mesh, and the checks of the config fields."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from unipose_tpu.parallel.mesh import make_mesh as jax_make_mesh
from unipose_tpu.parallel.mesh import shard_batch as jax_shard_batch
from unipose_tpu_torch.core.config import PRESETS, ModelConfig, TrainConfig
from unipose_tpu_torch.parallel import mesh as mesh_mod
from unipose_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch


@pytest.fixture
def recorder(monkeypatch):
    """Every process-group and device call maybe_init_distributed could
    make, recorded instead of made."""
    calls = []
    monkeypatch.setitem(mesh_mod._state, "device", None)
    for name in ("init_process_group", "is_initialized", "get_rank", "get_world_size"):
        monkeypatch.setattr(dist, name, lambda *a, _n=name, **k: calls.append((_n, a, k)))
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.append(("set_device", (d,), {})))
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    return calls


def test_init_is_a_noop_without_a_launcher(recorder):
    assert mesh_mod.maybe_init_distributed() is None
    assert mesh_mod.maybe_init_distributed("cpu") is None
    assert recorder == []


@pytest.mark.parametrize("device,backend,want", [
    (None, "nccl", torch.device("cuda", 1)),
    ("cuda", "nccl", torch.device("cuda", 1)),
    ("cpu", "gloo", torch.device("cpu")),
], ids=["card_default", "card", "cpu"])
def test_init_picks_backend_rank_and_device(recorder, monkeypatch, device, backend, want):
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert mesh_mod.maybe_init_distributed(device) == want
    inits = [c for c in recorder if c[0] == "init_process_group"]
    assert len(inits) == 1 and inits[0][1] == (backend,)
    assert inits[0][2]["world_size"] == 4 and inits[0][2]["rank"] == 3
    assert inits[0][2]["init_method"] == "env://"
    assert (("set_device", (want,), {}) in recorder) == (want.type == "cuda")
    # the first call decides; a second makes none
    n = len(recorder)
    assert mesh_mod.maybe_init_distributed(device) == want and len(recorder) == n


def test_init_backend_override(recorder, monkeypatch):
    """Two ranks sharing one card go over gloo: NCCL refuses them."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    dev = mesh_mod.maybe_init_distributed("cuda:0", backend="gloo", init_method="file:///x")
    assert dev == torch.device("cuda", 0)
    (init,) = [c for c in recorder if c[0] == "init_process_group"]
    assert init[1] == ("gloo",) and init[2]["init_method"] == "file:///x"


def test_make_mesh_resolves_minus_one_as_jax(eight_devices):
    for shape, axes in (((-1,), ("data",)), ((2, -1), ("data", "time")), ((-1, 4), ("data", "time"))):
        ours = make_mesh(shape, axes, world=8)
        ref = jax_make_mesh(shape, axes)
        assert ours.shape == ref.devices.shape and ours.axis_names == ref.axis_names
        assert ours.size == 8 and ours.world == 8
    assert make_mesh((-1,)).shape == (1,)  # one process, no group
    m = make_mesh((2, 4), ("data", "time"), world=8, rank=5)
    assert (m.coordinate("data"), m.coordinate("time"), m.coordinate("model")) == (1, 1, 0)
    assert m.axis_size("data") == 2 and m.axis_size("model") == 1


def test_make_mesh_rejects_stranded_ranks_as_jax(eight_devices):
    """tests/test_mesh.py:181: the same errors and warnings, by message."""
    for shape, axes, match in (((-1, 3), ("data", "time"), "stranding 2"),
                               ((3,), ("data",), "stranding 5"), ((16,), ("data",), "devices")):
        with pytest.raises(ValueError, match=match):
            make_mesh(shape, axes, world=8)
        with pytest.raises(ValueError, match=match):
            jax_make_mesh(shape, axes)
    with pytest.warns(UserWarning, match="7 idle"):
        assert make_mesh((1,), world=8).shape == (1,)
    with pytest.warns(UserWarning, match="6 idle"):
        assert make_mesh((2,), world=8).shape == (2,)
    with pytest.raises(ValueError, match="at least 3"):
        make_mesh((3, -1), ("data", "time"), world=2)


def test_shard_batch_rows_match_jax(eight_devices):
    """Rank i's rows are what JAX's shard_batch puts on device i of an
    8-way data mesh; the ranks' rows, concatenated, are the batch; leaves
    without a leading axis pass through; an indivisible batch raises."""
    rng = np.random.RandomState(0)
    batch = {"image": rng.rand(16, 4, 4, 3).astype(np.float32),
             "kpts": rng.rand(16, 14, 3).astype(np.float32), "paths": "abc"}
    ref = jax_shard_batch({k: v for k, v in batch.items() if k != "paths"}, jax_make_mesh((8,), ("data",)))
    rows = [shard_batch(batch, make_mesh((8,), world=8, rank=r)) for r in range(8)]
    for k in ("image", "kpts"):
        by_device = {s.device: np.asarray(s.data) for s in ref[k].addressable_shards}
        devices = jax_make_mesh((8,), ("data",)).devices.reshape(-1)
        for r in range(8):
            np.testing.assert_array_equal(rows[r][k], by_device[devices[r]])
        np.testing.assert_array_equal(np.concatenate([r[k] for r in rows]), batch[k])
    assert rows[3]["paths"] == "abc"
    with pytest.raises(ValueError, match="divisible"):
        shard_batch({"x": np.zeros((6, 2))}, make_mesh((4,), world=4))
    assert shard_batch(batch, Mesh((1,), ("data",)))["image"] is batch["image"]


def test_config_fields_as_jax():
    """sync_bn, mesh_shape and mesh_axes with the JAX defaults; preset 5
    with the JAX values."""
    from unipose_tpu.core import config as jax_config

    assert ModelConfig().sync_bn is jax_config.ModelConfig().sync_bn is True
    assert TrainConfig().mesh_shape == jax_config.TrainConfig().mesh_shape == (1,)
    assert TrainConfig().mesh_axes == jax_config.TrainConfig().mesh_axes == ("data",)
    ours, ref = PRESETS["multichip_video"], jax_config.PRESETS["multichip_video"]
    assert ours.model.sync_bn is ref.model.sync_bn is True
    assert ours.train.mesh_shape == ref.train.mesh_shape == (-1,)
    assert not hasattr(TrainConfig(), "donate_state")
