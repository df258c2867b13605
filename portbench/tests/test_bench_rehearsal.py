"""A tiny CPU rehearsal of each cell: the whole run but the look for a card,
at a few rows, prints a well-formed last line."""

from __future__ import annotations

import json

import pytest

from bench_small import CELLS, small
from portbench import run
from portbench.harness import core

BENCH = core.benchmark()


def rehearse(cell, trace, capsys, seed=2**31 + 99):
    args = run.parse(["--workload", cell, "--seed", str(seed), "--seconds", "0.05",
                      "--trace", str(trace)])
    result = run.run(args, device="cpu", cell_override=small)
    assert run.emit(result) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _metrics(kind, cell):
    return {m["name"] for m in BENCH[kind] if cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("cell", CELLS)
def test_end_to_end_line(cell, capsys):
    line = rehearse(cell, 0, capsys)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == _metrics("end_to_end", cell)
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["device"]["count"] == 1
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_traced_line(cell, capsys):
    """On the CPU the profiler sees no device, so only the per-layer metrics
    read from spans and counts are there; the rest are left out, not 0."""
    line = rehearse(cell, 1, capsys)
    assert line["correct"], line["checks"]  # the traced unit leaves the check as it was
    assert set(line["metrics"]) <= _metrics("per_layer", cell)
    assert line["metrics"] and all(m["value"] > 0 for m in line["metrics"].values())
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
