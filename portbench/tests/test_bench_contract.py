"""BENCHMARK.json keeps to its contract, and every name in it has its file."""

from __future__ import annotations

import re

import pytest

from portbench.harness import core

BENCH = core.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert cells <= 24 and sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, cells // 4)


def test_configs():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("portbench/") and (core.ROOT / c["file"]).exists()
        assert core.read_json(core.ROOT / c["file"])["name"] == c["name"]
        assert len(c["why"]) <= 200 and len(c["source"]) <= 200


def test_cells():
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (core.BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert set(core.read_json(core.BENCH / "limits" / f"{w['name']}.json"))
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"])


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(kind):
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH[kind]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        else:
            assert m["moves"] in e2e and callable(core.metric_reader(m["name"]))
    if kind == "end_to_end":
        assert "setup_s" in e2e and all(m["bound"] <= 0.25 for m in BENCH[kind])


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        e2e = [m for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        layer = [m for m in BENCH["per_layer"]
                 if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer
