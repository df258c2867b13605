"""The port's tracer (``utils/profiling``) and the spans and counters the
program records with it.

* Off (the default): ``span`` is the one shared null context, no
  ``record_function`` is entered, ``count`` adds nothing.
* On, under a patched ``perf_counter_ns``: nested spans give exact counts,
  durations and self times; counters add; ``enable`` resets, ``disable``
  stops.  Under a CPU ``torch.profiler`` session the spans are user
  annotations, nested as called; ``trace`` writes them to its Chrome trace.
* In the program: ``lift_clips``'s ``lift.init`` and ``lift.drain`` once
  per batch, ``lift.pack`` for the plan and once per batch, and its live and
  padded frames, worked out by hand; a ``GanTrainer``'s step spans once per batch, val without a backward
  or an optimizer span; ``run_inference``'s ``infer.*`` spans per batch; a
  one-rank gloo mesh's lifting, inference and G step.  Every result is
  bit-equal with the tracer on and off.
"""

import json
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.infer import run_inference
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.lifting import engine
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models import registry
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.parallel import (
    mesh as mesh_lib,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.train import gan
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils import profiling

B, T, DIN, DOUT, SIZE = 4, 32, 12, 24, 32


@pytest.fixture(autouse=True)
def tracer_off():
    """Each test starts and ends with the tracer off and its totals empty."""
    profiling.enable()
    profiling.disable()
    yield
    profiling.enable()
    profiling.disable()


def _traced(fn):
    """``fn()`` with the tracer on; returns (its result, the snapshot)."""
    profiling.enable()
    try:
        out = fn()
    finally:
        profiling.disable()
    return out, profiling.snapshot()


def test_off_is_one_null_context_and_never_marks(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with the tracer off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    a, b = profiling.span("x.a"), profiling.span("x.b")
    assert a is b
    with a:
        profiling.count("x.n", 3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("x.c"):
            pass
    assert profiling.snapshot() == {"spans": {}, "counts": {}}


def test_nested_spans_counts_and_self_times(monkeypatch):
    clock = iter(range(0, 10**9, 10**6))  # each reading 1 ms after the last
    monkeypatch.setattr(time, "perf_counter_ns", lambda: next(clock))
    profiling.enable()
    for _ in range(2):
        with profiling.span("p.outer"):  # reads t and t + 5 ms
            with profiling.span("p.inner"):  # 1 ms
                pass
            with profiling.span("p.inner"):  # 1 ms
                profiling.count("p.rows", 4)
    profiling.count("p.rows")
    snap = profiling.snapshot()
    assert snap["counts"] == {"p.rows": 9}
    exact = pytest.approx  # to the last bit of a nanosecond count times 1e-9
    assert snap["spans"] == {"p.inner": {"n": 4, "seconds": exact(4e-3, abs=1e-15),
                                         "self_seconds": exact(4e-3, abs=1e-15)},
                             "p.outer": {"n": 2, "seconds": exact(10e-3, abs=1e-15),
                                         "self_seconds": exact(6e-3, abs=1e-15)}}

    profiling.disable()
    with profiling.span("p.outer"):
        profiling.count("p.rows")
    assert profiling.snapshot() == snap  # off: nothing added, totals kept
    profiling.enable()
    assert profiling.snapshot() == {"spans": {}, "counts": {}}


def test_spans_are_user_annotations_under_the_profiler():
    from torch.profiler import ProfilerActivity, profile

    profiling.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("q.outer"):
            with profiling.span("q.inner"):
                torch.ones(4).sum()
    profiling.disable()
    marks = {e.name(): (e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()}
    assert set(marks) == {"q.outer", "q.inner"}
    (o0, o1), (i0, i1) = marks["q.outer"], marks["q.inner"]
    assert o0 <= i0 <= i1 <= o1
    assert profiling.snapshot()["spans"]["q.inner"]["n"] == 1


def test_trace_holds_the_programs_spans_and_restores_the_tracer(tmp_path):
    net = _generator()
    x = np.random.RandomState(0).randn(3, T, DIN).astype(np.float32)
    with profiling.trace(str(tmp_path)):
        run_inference(net, x, batch_size=2, device="cpu")
    (path,) = tmp_path.iterdir()
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {"infer.run", "infer.h2d", "infer.forward", "infer.d2h"} <= names
    assert profiling.span("after") is profiling.span("after")  # off again
    assert profiling.snapshot()["spans"]["infer.forward"]["n"] == 2


def _clips(lengths, seed=5):
    rng = np.random.RandomState(seed)
    out = []
    for n in lengths:
        kp = rng.uniform(100, 500, size=(n, 150)).astype(np.float32)
        kp[:, 2::3] = rng.uniform(0.5, 1.0, size=(n, 50))
        out.append(kp)
    return out


# lengths 40, 70, 70, 130 at t_bucket 64: buckets 64 (1 clip), 128 (2) and
# 192 (1).  Live frames 310; padded, rows to a power of two: 64 + 2 x 128 + 192
# = 512 in 3 batches, or 64 + 128 + 128 + 192 = 512 in 4 at one clip a batch
@pytest.mark.parametrize("max_batch,batches", [(128, 3), (1, 4)])
def test_lift_clips_spans_and_frames(max_batch, batches):
    clips = _clips([40, 70, 70, 130])

    def lift():
        return engine.lift_clips(clips, n_cycles=3, max_batch=max_batch, device="cpu")

    plain = lift()
    traced, snap = _traced(lift)
    assert snap["counts"] == {"lift.live_frames": 310, "lift.padded_frames": 512}
    assert {k: v["n"] for k, v in snap["spans"].items()} == {
        "lift.pack": 1 + batches, "lift.init": batches, "lift.drain": batches}
    for a, b in zip(plain, traced, strict=True):
        np.testing.assert_array_equal(a, b)


def _cfg(**over):
    return gan.GanConfig(**{**dict(feature_in_dim=DIN, feature_out_dim=DOUT, default_size=SIZE,
                                   window_t=T, batch_size=B, learning_rate=1e-4,
                                   dropout_rate=0.5, disc_label_smooth=True), **over})


@pytest.mark.parametrize("loss", ["L1", "RobustLoss"])
def test_gan_epochs_spans_and_losses(loss):
    rng = np.random.RandomState(1)
    X = rng.randn(3 * B, T, DIN).astype(np.float32)
    Y = rng.randn(3 * B, T, DOUT).astype(np.float32)

    def epochs():
        tr = gan.GanTrainer(_cfg(loss=loss), device="cpu")
        losses = [tr.run_epoch(X, Y, kind, b) for kind, b in
                  (("d", B), ("g", B), ("val", B // 2))]
        return losses, [p.detach().clone() for p in tr.generator.parameters()]

    plain, g_plain = epochs()
    (traced, g_traced), snap = _traced(epochs)
    assert plain == traced
    assert all(torch.equal(a, b) for a, b in zip(g_plain, g_traced, strict=True))
    n = {k: v["n"] for k, v in snap["spans"].items()}
    # 3 D and 3 G steps (12 rows at B), 6 val steps (at B / 2); val has a
    # forward only, a G or D step two optimizer spans (zero_grad, then step)
    assert n == {"train.d_step": 3, "train.g_step": 3, "train.val_step": 6,
                 "train.forward": 12, "train.backward": 6, "train.optim": 12}
    assert snap["counts"] == {}
    steps = sum(snap["spans"][f"train.{k}_step"]["seconds"] for k in ("g", "d", "val"))
    parts = sum(snap["spans"][f"train.{k}"]["seconds"] for k in ("forward", "backward", "optim"))
    assert parts <= steps


def _generator(text=False):
    return registry.build_generator("v1" if not text else "v2", DIN, DOUT, require_text=text,
                                    default_size=SIZE, dropout_rate=0.5, seed=3, device="cpu")


@pytest.mark.parametrize("text", [False, True])
def test_run_inference_spans_per_batch(text):
    rng = np.random.RandomState(2)
    x = rng.randn(5, T, DIN).astype(np.float32)
    f = rng.randn(5, 512).astype(np.float32) if text else None
    net = _generator(text)

    def infer():
        return run_inference(net, x, f, batch_size=2, device="cpu")[0]

    plain = infer()
    traced, snap = _traced(infer)
    np.testing.assert_array_equal(plain, traced)
    assert {k: v["n"] for k, v in snap["spans"].items()} == {
        "infer.run": 1, "infer.h2d": 3, "infer.forward": 3, "infer.d2h": 3}
    run = snap["spans"]["infer.run"]
    children = sum(snap["spans"][k]["seconds"] for k in ("infer.h2d", "infer.forward",
                                                         "infer.d2h"))
    assert run["self_seconds"] == pytest.approx(run["seconds"] - children, abs=1e-6)


def test_one_rank_mesh_with_the_tracer_on(tmp_path):
    """The mesh paths (a one-rank gloo group) give the same results with the
    tracer on as off, and record the same spans as the paths without one."""
    clips = _clips([40, 70])
    x = np.random.RandomState(4).randn(3, T, DIN).astype(np.float32)
    y = np.random.RandomState(5).randn(B, T, DOUT).astype(np.float32)
    net = _generator()

    def run(mesh):
        lifted = engine.lift_clips(clips, n_cycles=3, device="cpu", mesh=mesh)
        out = run_inference(net, x, batch_size=2, device="cpu", mesh=mesh)[0]
        tr = gan.GanTrainer(_cfg(dropout_rate=0.0), device="cpu", mesh=mesh)
        loss = float(tr.g_step(*(torch.from_numpy(a) for a in (x[:1].repeat(B, 0), y))))
        return lifted, out, loss

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                            world_size=1)
    try:
        mesh = mesh_lib.get_mesh()
        plain = run(mesh)
        (lifted, out, loss), snap = _traced(lambda: run(mesh))
    finally:
        dist.destroy_process_group()
    for a, b in zip(plain[0], lifted, strict=True):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(plain[1], out)
    assert plain[2] == loss
    assert snap["counts"] == {"lift.live_frames": 110, "lift.padded_frames": 64 + 128}
    assert {"lift.pack", "infer.run", "train.g_step", "train.optim"} <= set(snap["spans"])
