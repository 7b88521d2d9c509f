"""Profiling helpers.

Counterpart of ``unipose_tpu/utils/profiling.py``: ``trace``, a
``torch.profiler`` window over the host and the card that writes a Chrome
trace (view it in Perfetto or chrome://tracing), and ``StepTimer``, a
wall-clock timer of steady-state steps.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[profile]:
    """``with trace(dir): step(...)`` traces the host and, where there is
    one, the card, and writes ``<dir>/trace.json`` when the block ends."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Steady-state step timing: ``with timer: step()`` records the block's
    wall-clock seconds, leaving out the first ``skip`` blocks (the warm-up:
    cuDNN's algorithm search, the kernels' first build and load).

    CUDA calls return before the card has run them, so a step on the card
    must wait for its work inside the block, as the JAX callers block on
    the step's result there: end the block with
    ``torch.cuda.synchronize()`` or a copy of the result to the host."""

    def __init__(self, skip: int = 2):
        self.skip = skip
        self.times: List[float] = []
        self._t0: Optional[float] = None
        self._n = 0

    def __enter__(self) -> "StepTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter() - self._t0
        self._n += 1
        if self._n > self.skip:
            self.times.append(dt)

    @property
    def mean(self) -> float:
        """Mean seconds of the recorded steps (nan before the first)."""
        return sum(self.times) / len(self.times) if self.times else float("nan")

    def rate(self, items_per_step: int) -> float:
        """Items a second over the recorded steps (nan before the first)."""
        return items_per_step / self.mean if self.times else float("nan")
