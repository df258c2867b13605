"""The port's tracer: named spans and counters inside the program, and a
``torch.profiler`` trace written as a Chrome trace.

``span(name)`` times a block and ``count(name, n)`` adds to a counter.  Both
do nothing until ``enable()``: off, a span is one shared ``nullcontext`` and a
count returns at once, one check of a module flag per site.  On, a span adds
its duration (``time.perf_counter_ns``) and its self time (the duration less
that of the spans it encloses, kept online from a stack of the open spans) to
totals in memory, and ``snapshot()`` returns them; nothing grows with the
run.  While a profiler records, a span also enters
``torch.profiler.record_function(name)``, so it lies on the profiler's
timeline and clock beside the device's records.  The stack is the process's:
spans are opened on one thread.

Names are ``<layer>.<part>``: ``lift.*`` in ``lifting/engine.lift_clips``
(the count ``lift.init_kernel`` in ``ops/lift_init``, a batch whose walk
along the bone tree took the CUDA kernel),
``train.*`` in ``train/gan.GanTrainer``'s steps (``train.dead_branch`` in
v4_deeper's train-mode forward, ``models/generators``), ``infer.*`` in
``infer.run_inference``, the counts ``convert.calls`` and
``convert.staged_bytes`` in ``ops/batching.apply_clipwise`` (the conversions'
calls and their bytes through page-locked memory), ``classif.*`` in
``train/classifier.ClassifierTrainer``'s steps and batch copies (the count
``classif.rnn_calls`` in ``models/classifier.ClassifLSTM``, one a layer's
LSTM call).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

_NULL = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled

_on = False
_stack: list = []  # the open spans, innermost last
_spans: dict = {}  # name -> [n, nanoseconds, self nanoseconds]
_counts: dict = {}  # name -> total


class _Span:
    __slots__ = ("name", "mark", "t0", "children")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.mark = None
        if _profiling():
            self.mark = torch.profiler.record_function(self.name)
            self.mark.__enter__()
        self.children = 0
        _stack.append(self)
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        _stack.pop()
        if _stack:
            _stack[-1].children += dt
        total = _spans.get(self.name)
        if total is None:
            total = _spans[self.name] = [0, 0, 0]
        total[0] += 1
        total[1] += dt
        total[2] += dt - self.children
        if self.mark is not None:
            self.mark.__exit__(*exc)
        return False


def span(name: str):
    """A context manager timing its block as the span ``name`` while the
    tracer is on; the shared null context while it is off."""
    if not _on:
        return _NULL
    return _Span(name)


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name`` while the tracer is on."""
    if _on:
        _counts[name] = _counts.get(name, 0) + n


def enable() -> None:
    """Turn the tracer on, with its totals reset."""
    global _on
    _spans.clear()
    _counts.clear()
    _on = True


def disable() -> None:
    """Turn the tracer off; its totals stay for ``snapshot``."""
    global _on
    _on = False


def snapshot() -> dict:
    """The totals since the last ``enable``: ``{"spans": {name: {"n",
    "seconds", "self_seconds"}}, "counts": {name: value}}``."""
    return {"spans": {name: {"n": n, "seconds": ns * 1e-9, "self_seconds": own * 1e-9}
                      for name, (n, ns, own) in _spans.items()},
            "counts": dict(_counts)}


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the block with ``torch.profiler``, the tracer on, and write its
    Chrome trace (the program's spans among its records) to
    ``log_dir/trace_<pid>_<ns>.json``; the CUDA activity is recorded too when
    a CUDA device is available.  The tracer's state is put back afterwards.
    A no-op for ``log_dir`` None.  Yields the profiler (None for the
    no-op)."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    global _on
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    was, _on = _on, True
    try:
        with profile(activities=activities) as prof:
            yield prof
            if cuda:
                torch.cuda.synchronize()
    finally:
        _on = was
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.monotonic_ns()}.json"))
