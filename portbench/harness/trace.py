"""Read a ``torch.profiler`` session of the card: how long the device was
busy, each kernel's device time and launch count, and where it sat idle.

Busy time is the union of every device interval the profiler recorded
(kernels, copies, sets), so overlapping streams count once.  The idle gaps
are the stretches between those intervals, each named by what the host was
doing at its start: the innermost host operation open then, under the
harness's own span (``record_function``) that held it.
"""

from __future__ import annotations

import heapq
import time
from dataclasses import dataclass, field

import torch

TOP = 10  # entries of each breakdown list


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernel_s: dict = field(default_factory=dict)  # name -> device seconds
    kernel_n: dict = field(default_factory=dict)  # name -> launches
    device_ops: list = field(default_factory=list)  # [[name, seconds]] top TOP
    idle_gaps: list = field(default_factory=list)  # [[host activity, seconds]] top TOP
    counts: dict = field(default_factory=dict)  # work done inside the traced unit

    def seconds_of(self, part):
        """Device seconds and launches of the kernels whose name holds ``part``."""
        names = [k for k in self.kernel_s if part in k]
        return sum(self.kernel_s[k] for k in names), sum(self.kernel_n[k] for k in names)


def _merge(spans):
    merged = []
    for start, end in sorted(spans):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _label_gaps(host, spans, gaps):
    """{label: idle seconds} over ``gaps`` [(start, end)] (us, sorted), each
    labelled by the innermost host event open at its start (a sweep with a
    heap of open events, latest start on top) under the harness span open
    then."""
    out, heap, i = {}, [], 0
    for a, b in gaps:
        while i < len(host) and host[i][0] <= a:
            heapq.heappush(heap, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while heap and heap[0][1] < a:
            heapq.heappop(heap)
        inner = heap[0][2] if heap else "host idle"
        outer = next((n for s, e, n in spans if s <= a <= e), None)
        label = f"{outer} / {inner}" if outer and outer != inner else inner
        out[label] = out.get(label, 0.0) + (b - a) * 1e-6
    return out


def traced(fn, span_names=(), host=True):
    """Run ``fn()`` under the profiler and return its ``Trace``; ``fn``
    returns a dict of the work it did, kept as ``Trace.counts``.
    ``span_names``: the harness's span names, to tell them from the
    program's host operations.  ``host=False`` records the card's
    activity alone (its busy time and kernels; no idle gap is named), which
    costs the host far less: for a whole measured window."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] if host or not torch.cuda.is_available() else []
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        counts = fn() or {}
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        window = time.perf_counter() - t0
    # the profiler's raw records (nanoseconds): building its event tree
    # (``prof.events()``) takes minutes for a training cycle's records
    records = []
    for e in prof.profiler.kineto_results.events():
        marked = getattr(e, "is_user_annotation", None)
        records.append((e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3,
                        e.device_type() == torch.autograd.DeviceType.CUDA,
                        bool(marked()) if marked is not None else False))
    # a range marked on the host (the harness's spans, the program's
    # ``record_function``s) is also drawn on the device's timeline: not work
    harness = set(span_names)
    marks = harness | {n for n, _, _, dev, m in records if m and not dev}
    device, host, spans = [], [], []
    kernel_s, kernel_n = {}, {}
    for name, start, end, on_device, marked in records:
        if on_device and (marked or name in marks):
            continue
        if name in harness:
            spans.append((start, end, name))
        elif on_device:
            device.append((start, end))
            kernel_s[name] = kernel_s.get(name, 0.0) + (end - start) * 1e-6
            kernel_n[name] = kernel_n.get(name, 0) + 1
        else:
            host.append((start, end, name))
    merged = _merge(device)
    busy = sum(end - start for start, end in merged) * 1e-6
    host.sort()
    gaps = _label_gaps(host, sorted(spans), [(a[1], b[0]) for a, b in zip(merged, merged[1:])])
    top = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
    return Trace(
        window_s=window, busy_s=busy, kernel_s=kernel_s, kernel_n=kernel_n,
        device_ops=[[k, v] for k, v in top],
        idle_gaps=[[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]],
        counts=counts,
    )
