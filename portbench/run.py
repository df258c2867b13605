#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload v1_arm2wh.train --seed 7 --seconds 30 --trace 0

From the root of a checkout.  The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration (``portbench/configs/<name>.json``) and a traffic mix
(``portbench/traffic/<name>.json``, whose ``generator`` names the module in
``portbench/generators/``).  Set-up builds the inputs and the program's state from
``--seed`` and warms every shape up; the window then runs for ``--seconds``;
with ``--trace 1`` one more unit of the traffic runs under ``torch.profiler``
and the cell's per-layer metrics (``portbench/metrics/<name>.py``) are read.
Once the program's state is freed, the plain reference (``portbench/reference``)
judges what the timed path produced against ``portbench/limits/<cell>.json``.
The last line of standard output is the result, as JSON; the numbers compared
are the last lines of standard error.  Exits non-zero, printing no result,
without enough CUDA devices, or when a JAX module was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# every build and kernel cache stays at a fixed path inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "cache" / sub)
os.environ["USE_FLAX"] = "0"

TRACE_SESSIONS = 3  # the profiler now and then loses a session's kernels


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def run(args, device="cuda", cell_override=None, t_start=T_START):
    """One run of the cell; returns the result dict (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, [``breakdown``],
    ``checks``).  ``cell_override(cfg, traffic)`` resizes the cell for the
    CPU tests, which pass ``device="cpu"``."""
    import torch

    from portbench.harness import compare, core, trace

    bench = core.benchmark()
    w, cfg, traffic, limits = core.cell_files(bench, args.workload)
    if device == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < w["chips"]:
            raise SystemExit(f"{args.workload} needs {w['chips']} CUDA device(s), found {n}")
    if cell_override is not None:
        cfg, traffic = cell_override(cfg, traffic)
    mix = importlib.import_module(f"portbench.generators.{traffic['generator']}")
    rec = core.Recorder()
    cell = mix.Cell(cfg, traffic, args.seed, device, rec)
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s; window {args.seconds} s")

    window_trace = None
    if not args.trace and device == "cuda" and getattr(mix, "WINDOW_DEVICE_TRACE", False):
        # an end-to-end metric of the card's busy time: the whole window's device records
        window_trace = trace.traced(lambda: cell.window(args.seconds), mix.SPANS, host=False)
    else:
        cell.window(args.seconds)
    dev = core.device_info(device, w["chips"])
    wanted = [m for m in (bench["per_layer"] if args.trace else bench["end_to_end"])
              if args.workload in m.get("workloads", [args.workload])]
    metrics, breakdown = {}, None
    if args.trace:
        # the window's spans and counts, before a traced unit adds to them
        spans = {k: list(v) for k, v in rec.spans.items()}
        counted = {**rec.counts, **cell.layer_counts()}
        readers = {m["name"]: core.metric_reader(m["name"]) for m in wanted}
        for session in range(TRACE_SESSIONS):
            tr = trace.traced(cell.traced_unit, mix.SPANS)
            reading = Reading(spans, counted, tr)
            values = {name: read(reading) for name, read in readers.items()}
            if all(v is not None for v in values.values()):
                break
            log(f"trace session {session + 1}: nothing to read for "
                f"{sorted(k for k, v in values.items() if v is None)}")
        for m in wanted:
            if values[m["name"]] is not None:
                metrics[m["name"]] = core.metric(values[m["name"]], m["unit"])
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        breakdown = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
    else:
        e2e = cell.end_to_end(window_trace) if window_trace is not None else cell.end_to_end()
        for m in wanted:
            value = setup_s if m["name"] == "setup_s" else e2e[m["name"]]
            metrics[m["name"]] = core.metric(value, m["unit"])
    attempted, failed = cell.attempted, cell.failed
    cell.free()  # the program's state; what the window produced stays for the check
    if device == "cuda":
        torch.cuda.empty_cache()
    checks, ok = compare.judged(cell.check(), limits)
    result = {"correct": bool(ok and failed == 0), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


class Reading:
    """What a per-layer metric reads: the window's spans ({name: [seconds]})
    and counts, and the traced unit's ``trace.Trace``."""

    def __init__(self, spans, counts, tr):
        self.spans, self.counts, self.trace = spans, counts, tr


def emit(result):
    """Print the numbers compared, each beside its limit, as the last lines
    of standard error, then the result as the last line of standard output;
    or, if a JAX module was loaded, name it and print no result.  Returns
    the exit code."""
    from portbench.harness import core

    found = core.loaded_forbidden()
    if found:
        log(f"JAX modules were loaded in this process: {found}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None):
    return emit(run(parse(argv)))


if __name__ == "__main__":
    sys.exit(main())
