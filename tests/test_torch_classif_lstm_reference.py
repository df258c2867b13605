"""The port's bidirectional LSTM topic classifier against the benchmark's
plain reference (``portbench/reference/classifier.py``), on the CPU at the
published input width (288) and a small model and batch (hidden 16, 3
layers, B 4, T 24).

The port runs float32 and the reference float64 from the same seed: the
weights are drawn alike (bit-equal), and both draw their dropout masks as
float32 from generators in the same state, one mask a layer but the last,
in the order the layers run.

Tolerances, float32 against float64: the forwards' logits 1e-5 of the
largest (float32 rounding through 3 layers of 24 recurrent steps; measured
here ~1e-7); the train step's relative loss gap 1e-6 (a float32 mean of 4
cross-entropies); the worst leaf's gradient-norm gap 1e-5 (float32 sums
over the recurrence); the norms of the weights' change 1e-4 (Adam's
update is ~lr x sign(g + wd p) except where that sum is near its eps, and
in a leaf of ~1K elements one such element moves the norm by ~1e-5;
measured 1.3e-5); the row blocks' gradients against the whole batch's 1e-12
(float64 sums in another order).  The gaps are the benchmark's own
(``classif_train.judge_first_steps`` / ``judge_epoch``).
"""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models.classifier import (
    build_classifier,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models.layers import (
    set_dropout_generator,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.train.classifier import (
    ClassifierTrainer,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils import profiling
from portbench.generators import classif_train as mix
from portbench.harness import core
from portbench.reference import classifier as ref

B, T, H, L = 4, 24, 16, 3
PUBLISHED = core.read_json(core.BENCH / "configs" / "classif_lstm_1024x10.json")
CFG = {**PUBLISHED, "hidden_size": H, "num_layers": L, "batch_size": B, "window_t": T}
TRAFFIC = {"generator": "classif_train", "train_batches": 3, "val_batches": 1}
SEED = 2**31 + 20
FWD_RTOL = 1e-5
LOSS_RTOL = 1e-6
GRAD_GAP = 1e-5
STEP_GAP = 1e-4
BLOCK_RTOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The LSTMs' CPU paths are thousands of tiny ops a step; under the test
    runner's parallel workers OpenMP's waiting threads would spin on the
    shared cores, so torch runs on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(remat=False):
    return build_classifier("lstm", seed=SEED, device="cpu", input_size=CFG["input_size"],
                            hidden_size=H, num_layers=L, num_classes=CFG["num_classes"],
                            bidirectional=True, dropout=CFG["dropout"], remat=remat)


def _inputs():
    X, Y = mix.make_windows(B, CFG, SEED, 0)
    return torch.from_numpy(X), Y


def _rel(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.fixture(scope="module")
def cell():
    """The benchmark cell's set-up through ``ClassifierTrainer``: the first
    train and eval steps."""
    return mix.Cell(CFG, TRAFFIC, SEED, "cpu", core.Recorder())


def test_same_seeded_weights():
    port = list(_port().parameters())
    want = ref.init_weights(CFG, SEED, torch.float32)
    assert [tuple(p.shape) for p in port] == ref.shapes(CFG)
    for p, w in zip(port, want, strict=True):
        assert torch.equal(p.detach(), w)


def test_windows_are_rotations():
    """Each joint's six numbers are two orthonormal columns."""
    X, Y = mix.make_windows(3, CFG, SEED, 0)
    cols = X.reshape(3, T, -1, 2, 3).astype(np.float64)
    assert np.allclose((cols ** 2).sum(-1), 1.0, atol=1e-5)
    assert np.allclose((cols[..., 0, :] * cols[..., 1, :]).sum(-1), 0.0, atol=1e-5)
    assert Y.min() >= 1 and Y.max() <= CFG["num_classes"]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward(train):
    """The per-timestep logits; in train mode with equal dropout masks, and
    the two generators in the same state after."""
    port = _port().train(train)
    gp, gr = torch.Generator().manual_seed(SEED), torch.Generator().manual_seed(SEED)
    set_dropout_generator(port, gp)
    x, _ = _inputs()
    with torch.no_grad():
        y = port(x)
    masks = ref.draw_masks(CFG, gr, B, T, "cpu") if train else None
    y_ref = ref.forward(CFG, ref.init_weights(CFG, SEED), x.double(), masks)
    assert _rel(y, y_ref) < FWD_RTOL
    assert torch.equal(gp.get_state(), gr.get_state())


def test_first_steps_through_the_trainer(cell):
    r = ref.first_steps(CFG, SEED, cell.rng0, *cell.first_batches, "cpu")
    gaps = dict(mix.judge_first_steps(cell.first, r))
    assert gaps["loss_gap"] < LOSS_RTOL and gaps["grad_gap"] < GRAD_GAP, gaps
    assert gaps["step_gap"] < STEP_GAP and gaps["eval_gap"] < FWD_RTOL, gaps


def test_an_epoch_against_the_replay_and_a_shifted_replay(cell):
    """A train epoch from a copy of the trainer's state; a replay whose
    masks come one draw later in the stream is told apart."""
    state = cell._state()
    losses, _ = cell.tr.train_epoch(cell.X, cell.Y, B)
    after = [p.detach().clone() for p in cell.tr.module.parameters()]
    prog = {"losses": losses, "changes": [a - b for a, b in zip(after, state["weights"])]}
    gaps = dict(mix.judge_epoch(prog, ref.replay_epoch(CFG, state, cell.X, cell.Y, B, "cpu")))
    assert gaps["epoch_loss_gap"] < LOSS_RTOL and gaps["epoch_step_gap"] < STEP_GAP, gaps
    bad = dict(mix.judge_epoch(prog, ref.replay_epoch(CFG, state, cell.X, cell.Y, B, "cpu",
                                                      faults=("shift_masks",))))
    assert bad["epoch_loss_gap"] > 100 * LOSS_RTOL, bad


@pytest.mark.parametrize("block_rows", [1, 3])
def test_row_blocks_sum_to_the_batch(block_rows):
    X, Y = mix.make_windows(B, CFG, SEED, 0)
    state = torch.Generator().manual_seed(SEED).get_state()
    whole = ref.Trainer.from_seed(CFG, SEED, state, "cpu")
    parts = ref.Trainer.from_seed(CFG, SEED, state, "cpu")
    loss = whole.train_step(X, Y, block_rows=B)
    assert abs(parts.train_step(X, Y, block_rows=block_rows) - loss) < BLOCK_RTOL * loss
    # the last layer's reverse W_hh gets no gradient: at the last timestep,
    # the only one the loss reads, that direction has seen one input
    for g, h in zip(whole.first_grads, parts.first_grads, strict=True):
        assert float((h - g).abs().max()) <= BLOCK_RTOL * float(g.abs().max())


@pytest.mark.parametrize("kind", ["eval", "train"])
def test_step_flops_match_flop_counter(kind):
    x, _ = _inputs()
    with FlopCounterMode(display=False) as fc:
        ref.forward(CFG, ref.init_weights(CFG, SEED, torch.float32), x)
    assert ref.step_flops(CFG, kind, B, T) == fc.get_total_flops() * (3 if kind == "train" else 1)


def test_published_sizes():
    """237,424,650 parameters; a forward at B=128, T=192 is 11.66 TFLOP,
    474,521,600 a frame."""
    assert sum(int(np.prod(s)) for s in ref.shapes(PUBLISHED)) == 237_424_650
    assert ref.step_flops(PUBLISHED, "eval", 128, 192) == 474_521_600 * 128 * 192
    assert ref.step_flops(PUBLISHED, "train", 1, 1) == 3 * 474_521_600


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_spans_and_counters(remat):
    """With the tracer on: a train epoch of 2 batches and a val epoch of 1
    give 2 train steps (each with its forward, backward and two optimizer
    spans), 1 eval step, 3 batch copies, 3 B x T frames, and an LSTM call a
    layer and step (twice a layer in a train step under remat); nothing at
    all with the tracer off."""
    tr = ClassifierTrainer(_port(remat), learning_rate=1e-4, weight_decay=1e-3)
    X, Y = mix.make_windows(2 * B, CFG, SEED, 0)
    profiling.enable()
    profiling.disable()
    tr.train_epoch(X, Y, B)
    assert profiling.snapshot() == {"spans": {}, "counts": {}}
    try:
        profiling.enable()
        tr.train_epoch(X, Y, B)
        tr.val_epoch(X[:B], Y[:B], B)
        held = profiling.snapshot()
    finally:
        profiling.disable()
    n = {name: s["n"] for name, s in held["spans"].items()}
    assert n == {"classif.train_step": 2, "classif.forward": 2, "classif.backward": 2,
                 "classif.optim": 4, "classif.eval_step": 1, "classif.h2d": 3}
    assert held["counts"] == {"classif.frames": 3 * B * T,
                              "classif.rnn_calls": 2 * L * (2 if remat else 1) + L}
