"""Checkpoints of the whole train state: best-only, periodic with
auto-resume, and the warm start from a reference checkpoint.

Counterpart of ``unipose_tpu/train/checkpoint.py``.  Every file holds the
full ``TrainState.state_dict()`` (model, optimizer, scheduler, dropout
generator, step), written with ``torch.save``, so that training resumes
exactly from it.  ``save_checkpoint(state, is_best, filename)`` keeps the
reference's best-only semantics (utils/utils.py:53-56; trigger
unipose.py:183-186).  ``CheckpointManager`` is the periodic story, the
counterpart of JAX ``checkpoint.py:63-118`` (orbax there).

Across data-parallel ranks the ``Trainer`` has rank 0 alone save and every
rank restore; the state holds the bare model, never its DDP wrapper, so a
file's keys carry no ``module.`` prefix and load into any number of ranks.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import time
import weakref
from typing import List, Optional

import torch

from unipose_tpu_torch.compat.torch_convert import (
    load_state_dict_intersection,
    load_torch_checkpoint,
)


def save_checkpoint(state, is_best: bool, filename: str = "checkpoint") -> Optional[str]:
    """Write ``state.state_dict()`` to ``<filename>_best`` when ``is_best``;
    returns the path written, else None."""
    if not is_best:
        return None
    path = f"{filename}_best"
    torch.save(state.state_dict(), path)
    return path


def load_checkpoint(state, path: str):
    """Restore a file written by :func:`save_checkpoint` or
    :class:`CheckpointManager` into ``state``, and return it.  The file is
    read to host memory; ``load_state_dict`` puts each tensor where the
    state keeps it (parameters and moments on the model's device, Adam's
    step counts and the generator's state on the host)."""
    state.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    return state


def _host_copy(obj):
    """``obj`` (a state dict: nested dicts, lists and tuples) with every
    tensor copied to fresh host memory."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


# Live managers by directory: a new manager over a directory that another
# live manager is writing waits for that one's saves, and keeps a weak
# handle on it so that wait() and restore_latest() also wait for the saves
# it issues later (the JAX module's rule, checkpoint.py:52-61).
_LIVE_MANAGERS: "weakref.WeakValueDictionary[str, CheckpointManager]" = (
    weakref.WeakValueDictionary()
)


class CheckpointManager:
    """Periodic checkpoints with retention and latest-restore: the
    preemption and auto-resume story the reference lacks.

    ``save(step, state)`` copies every tensor of the state to host memory
    before it returns (the parameters and Adam moments change in place at
    the next step, so a writer that read the live tensors would write a
    torn state) and hands the file write to one writer thread: the train
    loop waits for the copy, not for the disk.  A save first waits for the
    previous write.  Each write goes to ``<step>.tmp`` and is committed by
    ``os.replace`` to ``<step>``; files that were never committed are
    ignored, so a process killed mid-write resumes from the previous step.
    The newest ``max_to_keep`` steps are kept.  ``wait()``/``close()`` block
    until pending writes commit; ``latest_step`` and ``restore_latest``
    wait first.  ``snapshot_ms`` and ``write_ms`` hold each save's time on
    the train thread and on the writer thread."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(os.path.expanduser(directory))
        self.max_to_keep = int(max_to_keep)
        os.makedirs(self.directory, exist_ok=True)
        prior = _LIVE_MANAGERS.get(self.directory)
        if prior is not None:
            prior.wait()
        self._prior = weakref.ref(prior) if prior is not None else None
        _LIVE_MANAGERS[self.directory] = self
        self._writer = cf.ThreadPoolExecutor(1, thread_name_prefix="checkpoint")
        self._pending: Optional[cf.Future] = None
        self.snapshot_ms: List[float] = []
        self.write_ms: List[float] = []

    def save(self, step: int, state) -> None:
        t0 = time.perf_counter()
        snapshot = _host_copy(state.state_dict())
        self.snapshot_ms.append((time.perf_counter() - t0) * 1e3)
        self._wait_own()
        self._pending = self._writer.submit(self._write, int(step), snapshot)

    def _write(self, step: int, snapshot: dict) -> None:
        t0 = time.perf_counter()
        path = os.path.join(self.directory, str(step))
        torch.save(snapshot, path + ".tmp")
        os.replace(path + ".tmp", path)
        for old in self.all_steps()[: -self.max_to_keep]:
            os.remove(os.path.join(self.directory, str(old)))
        self.write_ms.append((time.perf_counter() - t0) * 1e3)

    def _wait_own(self) -> None:
        if self._pending is not None:
            self._pending.result()  # raises what the write raised
            self._pending = None

    def wait(self) -> None:
        prior = self._prior() if self._prior is not None else None
        if prior is not None and prior is not self:
            prior.wait()
        self._wait_own()

    def all_steps(self) -> List[int]:
        """The committed steps, oldest first."""
        return sorted(int(n) for n in os.listdir(self.directory) if n.isdigit())

    def latest_step(self) -> Optional[int]:
        self.wait()
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore_latest(self, state):
        """Load the newest committed step into ``state`` (tensors onto the
        state's own device) and return it; None when there is none."""
        step = self.latest_step()
        if step is None:
            return None
        return load_checkpoint(state, os.path.join(self.directory, str(step)))

    def close(self) -> None:
        self.wait()
        self._writer.shutdown()


def warm_start_from_torch(state, torch_path: str):
    """Key-intersection warm start of ``state.model`` from a reference
    ``*.pth.tar`` (unipose.py:78-90 semantics).  Returns ``state``.

    The JAX signature's ``variant`` picks a layout conversion there; the
    port's modules carry the reference's keys in both variants (the LSTM's
    per-gate convs and top-level head too), so the intersection loads
    either without one."""
    report = load_state_dict_intersection(state.model, load_torch_checkpoint(torch_path))
    print(f"warm start: loaded {len(report['loaded'])} tensors, skipped {len(report['skipped'])}")
    return state
