"""The cell ``v4_deeper_text.train``: its counts and a CPU rehearsal at a
small size (B 8, T 64, 3 train batches; the widths as published), with its
own override (``bench_small.py`` sizes the first four cells)."""

from __future__ import annotations

import contextlib
import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models import generators
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils import profiling
from portbench import run
from portbench.harness import core, counts
from portbench.reference import models
from portbench.reference import models_v4_deeper as ref

CELL = "v4_deeper_text.train"
BENCH = core.benchmark()
CFG = core.read_json(core.BENCH / "configs" / "v4_deeper_text.json")


def small(cfg, traffic):
    return ({**cfg, "batch_size": 8, "window_t": 64},
            {**traffic, "train_batches": 3, "val_batches": 1})


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_flops_match_flop_counter(train):
    B, T = 2, CFG["window_t"]
    net = models.build_generator(CFG, 0, torch.float32).train(train)
    with FlopCounterMode(display=False) as fc:
        net(torch.zeros(B, CFG["feature_in_dim"], T), torch.zeros(B, 512))
    count = ref.generator_flops_train if train else counts.generator_flops
    assert count(CFG, B, T) == fc.get_total_flops()


def test_published_forward_sizes():
    """At B=128, T=192: 159.5 GFLOP an eval forward, 197.4 a train-mode one
    (the dead branch 37.85)."""
    assert counts.generator_flops(CFG, 128, 192) == 159_506_497_536
    assert ref.generator_flops_train(CFG, 128, 192) == 197_355_896_832


def test_step_rule():
    """G: the train-mode forward, the backward as twice the eval forward
    (no gradient reaches the dead branch), D's no-grad forward; D and val
    as ``counts.step_flops``."""
    g, d = counts.generator_flops(CFG, 8, 64), counts.discriminator_flops(CFG, 8, 64)
    assert ref.step_flops(CFG, "g", 8, 64) == ref.generator_flops_train(CFG, 8, 64) + 2 * g + d
    for kind in ("d", "val"):
        assert ref.step_flops(CFG, kind, 8, 64) == counts.step_flops(CFG, kind, 8, 64)


def rehearse(trace, capsys, seed=2**31 + 161):
    args = run.parse(["--workload", CELL, "--seed", str(seed), "--seconds", "0.05",
                      "--trace", str(trace)])
    assert run.emit(run.run(args, device="cpu", cell_override=small)) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _listed(kind, source=None):
    return {m["name"] for m in BENCH[kind] if CELL in m.get("workloads", [CELL])
            and source in (None, m["source"])}


def test_end_to_end_line(capsys):
    """The window runs with the port's tracer off: nothing recorded."""
    profiling.enable()
    profiling.disable()
    line = rehearse(0, capsys)
    assert profiling.snapshot() == {"spans": {}, "counts": {}}
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == _listed("end_to_end") == {"train_frames_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["attempted"] > 0 and line["failed"] == 0


def test_traced_line(capsys):
    """Every metric listed for the cell but those read from the device
    trace, which a CPU run has none of (they are left out, not 0)."""
    line = rehearse(1, capsys)
    assert profiling.span("probe") is profiling.span("probe")  # off again after the unit
    assert line["correct"], line["checks"]
    listed = _listed("per_layer")
    assert set(line["metrics"]) == listed - _listed("per_layer", "device_trace")
    assert {"dead_branch_ms_per_kframe", "dead_branch_g_step_share"} <= set(line["metrics"])
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["metrics"]["dead_branch_g_step_share"]["value"] < 100


def test_traced_line_without_the_programs_span(capsys, monkeypatch):
    """A program without the span and the counter (the port before they
    were added) gives a traced line that leaves the two metrics out."""
    monkeypatch.setattr(generators, "span", lambda name: contextlib.nullcontext())
    monkeypatch.setattr(generators, "count", lambda name, n=1: None)
    line = rehearse(1, capsys)
    assert line["correct"], line["checks"]
    assert not {"dead_branch_ms_per_kframe", "dead_branch_g_step_share"} & set(line["metrics"])
    assert "g_step_ms" in line["metrics"]
