"""Profiling helpers.

Counterpart of ``unipose_tpu/utils/profiling.py::trace``: a
``torch.profiler`` window over the host and the card that writes a Chrome
trace (view it in Perfetto or chrome://tracing).  ``StepTimer`` waits for
the long-tail slice.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

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
