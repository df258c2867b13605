"""The port's deepest generator, v4_deeper with text, against the
benchmark's plain reference (``portbench/reference/models_v4_deeper.py``),
on the CPU at the published widths (512-wide trunk, 36 -> 252, 512-d text)
and a small batch (B 4, T 64).

The port runs float32 and the reference float64 from the same seed.  Both
draw their dropout masks as float32 from generators in the same state, so
the masks are equal wherever the two draw in the same order; the dead
branch (conv8-10, the text, skip1, skip2) must therefore run in train mode
between conv7 and the upsample, or every later mask differs.

Tolerances, float32 against float64: the eval and train forwards 2e-4 of
the largest output (the generator's eval-forward rule, STATUS.md:363); the
BatchNorm running statistics 1e-5 (one float32 mean over B x T rows); the
steps' relative loss gaps 1e-5 and the worst leaf's gradient-norm gap 1e-4
(float32 sums over 64K-element losses; measured here 4.5e-7 and 6.5e-6);
the parameters' change 5e-3 (Adam's first step is lr x sign(g), and the
sign of a gradient that is float32 noise may flip; measured 1.8e-4).  The
gaps are the benchmark's own (``gan_train.judge_first_steps`` /
``judge_epochs``).
"""

import numpy as np
import pytest
import torch

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models import registry
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models.layers import (
    set_dropout_generator,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils import profiling
from portbench.generators import gan_train_v4_deeper as mix
from portbench.generators.gan_train import judge_epochs, judge_first_steps
from portbench.harness import core
from portbench.reference import models
from portbench.reference import models_v4_deeper as ref

B, T = 4, 64
CFG = {**core.read_json(core.BENCH / "configs" / "v4_deeper_text.json"),
       "batch_size": B, "window_t": T}
TRAFFIC = {"train_batches": 3, "val_batches": 1}
SEED = 2**31 + 16
FWD_RTOL = 2e-4
STAT_ATOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_GAP = 1e-4
STEP_GAP = 5e-3
DEAD = ("conv8", "conv9", "conv10", "text_embeds_postprocess", "skip1", "skip2")


def _port():
    return registry.build_generator("v4_deeper", CFG["feature_in_dim"], CFG["feature_out_dim"],
                                    require_text=True, default_size=CFG["default_size"],
                                    dropout_rate=CFG["dropout"], seed=SEED, device="cpu")


def _inputs():
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((B, CFG["feature_in_dim"], T)).astype(np.float32)
    f = rng.standard_normal((B, 512)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(f)


def _rel(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.fixture(scope="module")
def cell():
    """The benchmark cell's set-up through ``GanTrainer``: the first D, G
    and val steps on rows that all differ."""
    return mix.Cell(CFG, {**TRAFFIC, "generator": "gan_train_v4_deeper"}, SEED, "cpu",
                    core.Recorder())


def test_same_seeded_state_dict():
    port, want = _port().state_dict(), models.build_generator(CFG, SEED, torch.float32).state_dict()
    assert list(port) == list(want)
    for k in port:
        assert torch.equal(port[k], want[k]), k


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_and_the_dead_branch_state(train):
    """The output; in train mode also the dropout generator's state and the
    dead branch's BatchNorm statistics after the forward."""
    port, want = _port(), models.build_generator(CFG, SEED)
    gp, gr = torch.Generator().manual_seed(SEED), torch.Generator().manual_seed(SEED)
    set_dropout_generator(port, gp)
    models.set_dropout_generator(want, gr)
    port.train(train)
    want.train(train)
    x, f = _inputs()
    with torch.no_grad():
        y = port(x, f)
        y_ref = want(x.double(), f.double())
    assert _rel(y, y_ref) < FWD_RTOL
    assert torch.equal(gp.get_state(), gr.get_state())
    bufs, ref_bufs = dict(port.named_buffers()), dict(want.named_buffers())
    moved = 0
    for name, b in bufs.items():
        if name.split(".")[0] in DEAD and b.is_floating_point():
            assert float((b.double() - ref_bufs[name]).abs().max()) < STAT_ATOL, name
            moved += int(not torch.equal(b, torch.ones_like(b) if "var" in name
                                         else torch.zeros_like(b)))
    assert moved == (2 * len(DEAD) if train else 0)


def test_first_steps_through_the_trainer(cell):
    r = ref.first_steps(CFG, SEED, cell.batches, "cpu")
    gaps = dict(judge_first_steps(cell.first, r))
    assert gaps["loss_gap"] < LOSS_RTOL and gaps["grad_gap"] < GRAD_GAP, gaps
    assert gaps["step_gap"] < STEP_GAP, gaps
    # the dead branch's parameters got no gradient, on either side
    names = [n for n, _ in cell.tr.generator.named_parameters()]
    for n, g, g_ref in zip(names, cell.first["grads"], r["grads"]["G"]):
        dead = n.split(".")[0] in DEAD
        assert (not g.any()) == dead and (not g_ref.any()) == dead, n


def _g_epoch(cell):
    state = cell._state()
    X, Y, F = cell.train
    loss = cell.tr.run_epoch(X, Y, "g", B, F)
    after = [p.detach().clone() for p in cell.tr.generator.parameters()]
    prog = {"losses": [loss], "changes": [a - b for a, b in zip(after, state["G"])]}
    return prog, state, [("g", (X, Y, F), B)]


def test_a_g_epoch_against_the_replay_and_a_replay_without_the_branch(cell):
    prog, state, epochs = _g_epoch(cell)
    r = ref.replay_epochs(CFG, state, epochs, "cpu")
    gaps = dict(judge_epochs(prog, {"losses": r["losses"], "changes": r["changes"]["G"],
                                    "grads": r["grads"]["G"]}))
    assert gaps["epoch_loss_gap"] < LOSS_RTOL and gaps["epoch_step_gap"] < STEP_GAP, gaps
    # a reference that skips the branch in train mode draws every later
    # dropout mask from another place in the stream: the comparison bites
    with mix.without_dead_branch():
        r = ref.replay_epochs(CFG, state, epochs, "cpu")
    bad = dict(judge_epochs(prog, {"losses": r["losses"], "changes": r["changes"]["G"],
                                   "grads": r["grads"]["G"]}))
    assert bad["epoch_loss_gap"] > 10 * LOSS_RTOL and bad["epoch_step_gap"] > STEP_GAP, bad


def test_span_and_counter(cell):
    """One ``train.dead_branch`` and B x T frames a train-mode forward (a G
    step); none in eval, in a D step (G in eval) or a val step; nothing at
    all with the tracer off."""
    tr = cell.tr
    x, y, f = (torch.from_numpy(np.ascontiguousarray(a)) for a in cell.batches["g"])
    xv, yv, fv = (torch.from_numpy(np.ascontiguousarray(a)) for a in cell.batches["val"])
    profiling.enable()
    profiling.disable()
    tr.g_step(x, y, f)
    assert profiling.snapshot() == {"spans": {}, "counts": {}}
    try:
        profiling.enable()
        tr.d_step(x, y, f)
        tr.val_step(xv, yv, fv)
        with torch.no_grad():
            tr.generator.eval()(x.transpose(1, 2), f)
        held = profiling.snapshot()
        assert "train.dead_branch" not in held["spans"], held
        assert "train.dead_branch_frames" not in held["counts"], held
        tr.g_step(x, y, f)
        held = profiling.snapshot()
        assert held["spans"]["train.dead_branch"]["n"] == 1
        assert held["counts"]["train.dead_branch_frames"] == B * T
        assert 0 < held["spans"]["train.dead_branch"]["seconds"] < held["spans"]["train.g_step"]["seconds"]
    finally:
        profiling.disable()
