"""Step timing and traces for the port.

PyTorch counterpart of the JAX package's ``utils/profiling.py``: a step
timer, a ``torch.profiler`` trace written as a Chrome trace, and named
regions of that trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


class StepTimer:
    """Rolling per-step wall-clock stats; call tick() once per step."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.count = 0
        self.total = 0.0
        self.best = float("inf")
        self._last = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self.count += 1
            if self.count > self.warmup:
                dt = now - self._last
                self.total += dt
                self.best = min(self.best, dt)
        self._last = now

    @property
    def mean(self) -> float:
        n = max(self.count - self.warmup, 1)
        return self.total / n

    def summary(self) -> dict:
        return {"steps": self.count, "mean_s": self.mean, "best_s": self.best}


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the block with ``torch.profiler`` and write its Chrome trace
    to ``log_dir/trace_<pid>_<ns>.json``; the CUDA activity is recorded too
    when a CUDA device is available.  A no-op for ``log_dir`` None.  Yields
    the profiler (None for the no-op)."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.monotonic_ns()}.json"))


def annotate(name: str):
    """A named region of the profiler's timeline
    (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)
