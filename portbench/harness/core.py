"""What every cell shares: the benchmark's own files found by name, the
spans and counters the generators record, the device's description, the check
that no JAX module was loaded, and the result line.
"""

from __future__ import annotations

import importlib
import json
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]  # the checkout
BENCH = ROOT / "portbench"
# the reference JAX package and its stack: none may be loaded by a run
FORBIDDEN = ("jax", "jaxlib", "flax", "optax",
             "multimodal_hand_pose_enhancement_for_sign_language_tpu")


def read_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark():
    path = ROOT / "BENCHMARK.json"
    if not path.exists():
        raise SystemExit(f"no BENCHMARK.json at {ROOT}")
    return read_json(path)


def cell_files(bench, workload):
    """(workload entry, configuration, traffic parameters, limits) of the
    named cell, each from its own file: ``configs/<config>.json`` (the
    entry's ``file``), ``traffic/<traffic>.json`` and
    ``limits/<workload>.json``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = read_json(ROOT / configs[w["config"]]["file"])
    traffic = read_json(BENCH / "traffic" / f"{w['traffic']}.json")
    limits_path = BENCH / "limits" / f"{workload}.json"
    limits = read_json(limits_path) if limits_path.exists() else {}
    return w, cfg, traffic, limits


def metric_reader(name):
    """``metrics/<name>.py``'s ``read``; a dot in the name is an underscore
    in the file name."""
    return importlib.import_module(f"portbench.metrics.{name.replace('.', '_')}").read


def loaded_forbidden(modules=None):
    """Top-level names in ``sys.modules`` (the part before the first dot,
    compared whole) that are the JAX package or its stack."""
    tops = {name.split(".", 1)[0] for name in (sys.modules if modules is None else modules)}
    return sorted(tops.intersection(FORBIDDEN))


class Recorder:
    """Spans and counters of one run.  A span is timed on the host clock and
    marked for the profiler with its name; ``spans[name]`` keeps each
    span's seconds and ``counts`` the work the generators count."""

    def __init__(self):
        self.spans: dict = {}
        self.counts: dict = {}

    @contextmanager
    def span(self, name):
        with torch.profiler.record_function(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def add(self, name, value):
        self.counts[name] = self.counts.get(name, 0) + value


def device_info(device, chips):
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": chips, "memory_peak_bytes": 0}
    if dev.type == "cuda":
        info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    return info


def metric(value, unit):
    return {"value": value, "unit": unit}
