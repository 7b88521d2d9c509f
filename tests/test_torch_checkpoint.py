"""The port's periodic checkpoints (``train/checkpoint.py::
CheckpointManager``) on the CPU: a save is a host snapshot taken before it
returns, written by a thread and committed by a rename; uncommitted files
are ignored; ``max_to_keep`` holds; two managers over one directory see each
other's saves; and (slow) a training process killed with SIGKILL resumes
from its last committed checkpoint, the twin of
tests/test_preemption.py::test_kill_and_resume on the port's CLI."""

import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
import torch.nn as nn

from unipose_tpu_torch.core.config import TrainConfig
from unipose_tpu_torch.train import checkpoint
from unipose_tpu_torch.train.checkpoint import CheckpointManager
from unipose_tpu_torch.train.optim import make_optimizer
from unipose_tpu_torch.train.state import TrainState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _state(seed, steps=2):
    """A small train state (conv + BN, Adam, the step-decay scheduler, a
    generator) after ``steps`` updates, so every part holds values."""
    torch.manual_seed(seed)
    model = nn.Sequential(nn.Conv2d(3, 4, 3), nn.BatchNorm2d(4))
    optimizer, scheduler = make_optimizer(model.parameters(), TrainConfig(lr=1e-2, step_size=1))
    state = TrainState(model, optimizer, scheduler, torch.Generator().manual_seed(seed))
    for _ in range(steps):
        loss = model(torch.randn(2, 3, 6, 6)).square().mean()
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        scheduler.step()
        torch.rand(3, generator=state.generator)
        state.step += 1
    return state


def _assert_same(got: dict, want: dict):
    assert got["step"] == want["step"] and got["scheduler"] == want["scheduler"]
    assert torch.equal(got["generator"], want["generator"])
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    assert got["optimizer"]["param_groups"] == want["optimizer"]["param_groups"]
    for k, v in want["optimizer"]["state"].items():
        for name, t in v.items():
            assert torch.equal(got["optimizer"]["state"][k][name], t), (k, name)


def _clone(sd):
    return checkpoint._host_copy(sd)


def test_restore_latest_is_bit_identical(tmp_path):
    state = _state(0)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() is None and mgr.restore_latest(_state(1)) is None
    mgr.save(state.step, state)
    fresh = _state(1, steps=1)
    assert mgr.restore_latest(fresh) is fresh and fresh.step == 2
    _assert_same(fresh.state_dict(), state.state_dict())
    assert len(mgr.snapshot_ms) == len(mgr.write_ms) == 1
    mgr.close()


def test_save_snapshots_before_it_returns(tmp_path, monkeypatch):
    """The writer is held until the train thread has changed every tensor
    in place (as the next step does): the file still holds the values of
    the moment ``save`` was called."""
    release = threading.Event()
    real_save = torch.save

    def held_save(obj, path):
        assert release.wait(30)
        real_save(obj, path)

    monkeypatch.setattr(checkpoint.torch, "save", held_save)
    state = _state(2)
    want = _clone(state.state_dict())
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state.step, state)
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
        for s in state.optimizer.state.values():
            s["exp_avg"].mul_(3.0)
    release.set()
    mgr.wait()
    _assert_same(torch.load(tmp_path / "2", weights_only=True), want)


def test_uncommitted_files_are_ignored_and_max_to_keep_holds(tmp_path):
    state = _state(3)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=3)
    for step in range(1, 6):
        state.step = step
        mgr.save(step, state)
    (tmp_path / "9.tmp").write_bytes(b"a write that a kill cut short")
    (tmp_path / "notes").write_text("not a step")
    assert mgr.latest_step() == 5 and mgr.all_steps() == [3, 4, 5]
    fresh = _state(4, steps=1)
    mgr.restore_latest(fresh)
    assert fresh.step == 5
    _assert_same(fresh.state_dict(), state.state_dict())


def test_two_managers_over_one_directory(tmp_path, monkeypatch):
    """A manager opened over a directory that another live manager is
    writing waits for its saves, and keeps seeing the saves it issues
    later (the JAX module's _LIVE_MANAGERS rule)."""
    state = _state(5)
    first = CheckpointManager(str(tmp_path))
    release = threading.Event()
    real_save = torch.save
    monkeypatch.setattr(checkpoint.torch, "save",
                        lambda obj, path: (release.wait(30), real_save(obj, path)))
    first.save(2, state)
    threading.Timer(0.2, release.set).start()
    second = CheckpointManager(str(tmp_path))
    assert second.all_steps() == [2]
    state.step = 3
    first.save(3, state)
    assert second.latest_step() == 3


def test_a_failed_write_raises_at_wait(tmp_path, monkeypatch):
    def broken_save(obj, path):
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint.torch, "save", broken_save)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state(6))
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()


WORKER = r"""
import os, sys
import numpy as np, cv2, scipy.io
root = sys.argv[1]
img_dir = os.path.join(root, "images")
if not os.path.isdir(img_dir):
    os.makedirs(img_dir)
    rng = np.random.RandomState(0)
    n = 4
    for i in range(n):
        cv2.imwrite(os.path.join(img_dir, "im%05d.jpg" % (i + 1)),
                    rng.randint(0, 255, (60, 80, 3), np.uint8))
    joints = np.zeros((14, 3, n))
    joints[:, 0, :] = rng.uniform(5, 75, (14, n))
    joints[:, 1, :] = rng.uniform(5, 55, (14, n))
    joints[:, 2, :] = 1
    scipy.io.savemat(os.path.join(root, "joints.mat"), {"joints": joints})
from unipose_tpu_torch.cli import train
train.main(sys.argv[2:])
"""


@pytest.mark.slow
def test_kill_and_resume(tmp_path):
    """The CLI is killed with SIGKILL once it has started epoch 2 (by then
    epoch 1's save was issued, which waited for epoch 0's write); a fresh
    process resumes from a committed step, not from scratch.  Durability:
    at most one checkpoint interval is lost."""
    data_root = str(tmp_path / "lspet")
    argv = ["--dataset", "LSP", "--train_dir", data_root, "--checkpoint_dir",
            str(tmp_path / "ckpt"), "--model_name", "", "--batch_size", "2", "--lr", "1e-3",
            "--input_size", "64", "--epochs", "5", "--device", "cpu"]

    def launch():
        return subprocess.Popen([sys.executable, "-u", "-c", WORKER, data_root] + argv,
                                stdout=subprocess.PIPE, text=True, cwd=REPO)

    def read_until(p, prefix):
        lines, deadline = [], time.time() + 600
        while time.time() < deadline:
            line = p.stdout.readline()
            if not line:
                break
            lines.append(line.strip())
            if line.startswith(prefix):
                break
        return lines

    p = launch()
    try:
        lines = read_until(p, "Epoch 2:")
        assert lines and lines[-1].startswith("Epoch 2:"), lines
        os.kill(p.pid, signal.SIGKILL)
    finally:
        p.wait(timeout=60)

    p = launch()
    try:
        lines = read_until(p, "Epoch 0:")
        resumed = [l for l in lines if l.startswith("resumed from step")]
        assert resumed, lines
        assert int(resumed[0].split()[3]) >= 2, lines  # 4 samples / batch 2
    finally:
        os.kill(p.pid, signal.SIGKILL)
        p.wait(timeout=60)
    steps = sorted(int(n) for n in os.listdir(tmp_path / "ckpt") if n.isdigit())
    assert steps and np.all(np.diff(steps) > 0)
