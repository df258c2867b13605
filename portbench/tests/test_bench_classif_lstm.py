"""The cell ``classif_lstm_1024x10.train``: a CPU rehearsal at a small size
(hidden 256, 2 layers, B 4, T 16, 3 train batches; the input width as
published), its result lines, and the planted faults, each of which makes
the run not correct, traced or not.  The limits are the card's, set at the
published widths; a hidden size under ~128 reads `step_gap` above them, as
fewer elements a leaf make each float32-rounded Adam update count more."""

from __future__ import annotations

import contextlib
import json

import numpy as np
import pytest
import torch

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models import (
    classifier as models,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.train import (
    classifier as train,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils import profiling
from portbench import run
from portbench.harness import core

CELL = "classif_lstm_1024x10.train"
BENCH = core.benchmark()
SEED = 2**31 + 201
Trainer = train.ClassifierTrainer


def small(cfg, traffic):
    return ({**cfg, "hidden_size": 256, "num_layers": 2, "batch_size": 4, "window_t": 16},
            {**traffic, "train_batches": 3, "val_batches": 1})


def rehearse(trace):
    args = run.parse(["--workload", CELL, "--seed", str(SEED), "--seconds", "0.05",
                      "--trace", str(trace)])
    return run.run(args, device="cpu", cell_override=small)


def line(trace, capsys):
    assert run.emit(rehearse(trace)) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _listed(kind, source=None):
    return {m["name"] for m in BENCH[kind] if CELL in m.get("workloads", [CELL])
            and source in (None, m["source"])}


def test_end_to_end_line(capsys):
    """The window runs with the port's tracer off: nothing recorded."""
    profiling.enable()
    profiling.disable()
    got = line(0, capsys)
    assert profiling.snapshot() == {"spans": {}, "counts": {}}
    assert got["correct"], got["checks"]
    assert set(got["metrics"]) == _listed("end_to_end") == {"train_frames_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in got["metrics"].values())
    assert got["attempted"] > 0 and got["failed"] == 0


def test_traced_line(capsys):
    """Every metric listed for the cell but those read from the device
    trace, which a CPU run has none of (they are left out, not 0)."""
    got = line(1, capsys)
    assert profiling.span("probe") is profiling.span("probe")  # off again after the unit
    assert got["correct"], got["checks"]
    assert set(got["metrics"]) == _listed("per_layer") - _listed("per_layer", "device_trace")
    assert got["metrics"]["classif_rnn_calls_per_step"]["value"] == 2
    assert all(m["value"] > 0 for m in got["metrics"].values())


def test_traced_line_without_the_programs_counter(capsys, monkeypatch):
    """A program without the counter and the spans (the port before they
    were added) gives a traced line that leaves the metric out."""
    monkeypatch.setattr(models, "count", lambda name, n=1: None)
    monkeypatch.setattr(train, "count", lambda name, n=1: None)
    monkeypatch.setattr(train, "span", lambda name: contextlib.nullcontext())
    got = line(1, capsys)
    assert got["correct"], got["checks"]
    assert "classif_rnn_calls_per_step" not in got["metrics"]
    assert "classif_step_ms" in got["metrics"]


def _half_batch(monkeypatch):
    batch = Trainer._batch
    monkeypatch.setattr(Trainer, "_batch", lambda self, X, Y, sl: tuple(
        t[: len(t) // 2] for t in batch(self, X, Y, sl)))


def _batch_fed_twice(monkeypatch):
    """Every train epoch feeds its first batch again in place of its second."""
    epoch = Trainer.train_epoch

    def fed_twice(self, X, Y, batch_size):
        if len(X) >= 2 * batch_size:
            X, Y = X.copy(), Y.copy()
            X[batch_size:2 * batch_size], Y[batch_size:2 * batch_size] = X[:batch_size], Y[:batch_size]
        return epoch(self, X, Y, batch_size)

    monkeypatch.setattr(Trainer, "train_epoch", fed_twice)


def _masks_shifted(monkeypatch):
    """One number drawn from the dropout generator before each train step."""
    step = Trainer.train_step

    def shifted(self, x, labels):
        torch.rand(1, generator=self.dropout_generator, device=self.device)
        return step(self, x, labels)

    monkeypatch.setattr(Trainer, "train_step", shifted)


def _reverse_unreversed(monkeypatch):
    """Each layer's reverse direction runs over the input in its own order."""
    def run_layer(layer, x):
        H = layer.hidden_size
        out = layer(x)[0]
        return torch.cat([out[..., :H], layer(x.flip(1))[0][..., H:].flip(1)], -1)

    monkeypatch.setattr(models, "_run_layer", run_layer)


def _state_unchanged(monkeypatch):
    init = Trainer.__init__

    def patched(self, *a, **k):
        init(self, *a, **k)
        self.opt.step = lambda *args, **kwargs: None

    monkeypatch.setattr(Trainer, "__init__", patched)


def _adam_step_counter_stuck(monkeypatch):
    init = Trainer.__init__

    def patched(self, *a, **k):
        init(self, *a, **k)

        def step(*args, _step=self.opt.step, _opt=self.opt, **kwargs):
            _step(*args, **kwargs)
            for state in _opt.state.values():
                state["step"].fill_(1.0)

        self.opt.step = step

    monkeypatch.setattr(Trainer, "__init__", patched)


FAULTS = [_half_batch, _batch_fed_twice, _masks_shifted, _reverse_unreversed,
          _state_unchanged, _adam_step_counter_stuck]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__[1:] for f in FAULTS])
def test_fault_is_not_correct(fault, trace, monkeypatch):
    fault(monkeypatch)
    got = rehearse(trace)
    assert not got["correct"], got["checks"]
    assert np.isfinite(got["attempted"])
