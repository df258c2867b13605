"""Topic-classifier training traffic: the classifier CLI's epoch loop
(``classifier_main.run_epochs`` without ``--epoch_scan``) through the port's
``ClassifierTrainer.train_epoch`` and ``val_epoch``, with host-fed batches.

Set-up makes, in numpy from the seed, a pool of training windows and one of
validation windows, each (T, input) of valid r6d: per window and joint a
smooth axis-angle curve over time (a constant plus a sinusoid with its own
frequency and phase, per axis), turned into the first two columns of its
rotation matrix; labels are uniform over the classes, 1-based as on disk.  It
builds the model with ``build_classifier`` (weights from the seed; remat by
the CLI's own ``should_remat``) and the trainer (dropout generator seeded
from the seed), then runs a first train step (``train_epoch`` over the
pool's first batch) and a first eval step (``val_epoch`` over the val pool's
first batch): they warm every shape the window runs, and their loss, the
gradients, the weights' change and the eval step's last-timestep logits (read
by a hook on the head) are what ``check`` holds against the plain reference
(``reference/classifier``).  The window runs whole cycles, a train epoch over
the pool then a val epoch, the pool reshuffled on the host by a permuted copy
after each cycle as ``run_epochs`` does, until ``seconds`` have passed.  In
one of its first two cycles, drawn from the seed, it copies the trainer's
whole state (weights, Adam's moments and step, the dropout generator) before
the train epoch and the weights after; ``check`` has the reference replay
that epoch, all its batches, from that state and holds the steps' losses and
the weights' change against the program's.  It also holds Adam's step
counter against the train steps the harness counted.

``traced_unit`` is one cycle with the port's tracer on; it returns the
cycle's frames, the counter ``classif.rnn_calls`` and the number of
``classif.train_step`` and ``classif.eval_step`` spans.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models.classifier import (
    build_classifier,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.train.classifier import (
    ClassifierTrainer,
    should_remat,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils import profiling
from portbench.harness import compare
from portbench.reference import classifier as ref

SPANS = ("train_epoch", "val_epoch", "cycle")
CHUNK = 64  # windows converted at a time


def _rot6d(aa):
    """(..., 3) axis-angle -> (..., 6): the rotation matrix's first two
    columns (Rodrigues)."""
    theta = np.linalg.norm(aa, axis=-1, keepdims=True)
    k = aa / np.maximum(theta, 1e-12)
    s, c = np.sin(theta), np.cos(theta)
    kx, ky, kz = k[..., 0:1], k[..., 1:2], k[..., 2:3]
    col0 = np.concatenate([c + (1 - c) * kx * kx, s * kz + (1 - c) * ky * kx,
                           -s * ky + (1 - c) * kz * kx], -1)
    col1 = np.concatenate([-s * kz + (1 - c) * kx * ky, c + (1 - c) * ky * ky,
                           s * kx + (1 - c) * kz * ky], -1)
    return np.concatenate([col0, col1], -1)


def make_windows(n, cfg, seed, offset):
    """(X (n, T, input) float32 r6d, Y (n,) 1-based labels) from the seed."""
    rng = np.random.default_rng([seed, offset])
    T, joints = cfg["window_t"], cfg["input_size"] // 6
    t = (np.arange(T) / T)[None, :, None, None]
    X = np.empty((n, T, cfg["input_size"]), np.float32)
    for lo in range(0, n, CHUNK):
        m = min(CHUNK, n - lo)
        base = rng.normal(0.0, 0.6, (m, 1, joints, 3))
        amp = rng.normal(0.0, 0.3, (m, 1, joints, 3))
        freq = rng.uniform(0.5, 2.0, (m, 1, joints, 3))
        phase = rng.uniform(0.0, 2 * np.pi, (m, 1, joints, 3))
        aa = base + amp * np.sin(2 * np.pi * freq * t + phase)
        X[lo:lo + m] = _rot6d(aa).reshape(m, T, -1)
    Y = rng.integers(1, cfg["num_classes"] + 1, n)
    return X, Y


def build(cfg, seed, device):
    """The model and trainer as the classifier CLI builds them."""
    remat = should_remat(cfg["batch_size"], cfg["window_t"], cfg["hidden_size"],
                         cfg["num_layers"], cfg["bidirectional"], device=device)
    module = build_classifier(
        "lstm", seed=seed, device=device, input_size=cfg["input_size"],
        hidden_size=cfg["hidden_size"], num_layers=cfg["num_layers"],
        num_classes=cfg["num_classes"], bidirectional=cfg["bidirectional"],
        dropout=cfg["dropout"], remat=remat)
    return ClassifierTrainer(module, learning_rate=cfg["learning_rate"],
                             weight_decay=cfg["weight_decay"], optimizer=cfg["optimizer"],
                             dropout_seed=seed + 1)


class Cell:
    def __init__(self, cfg, traffic, seed, device, rec):
        self.cfg, self.seed, self.device, self.rec = cfg, seed, torch.device(device), rec
        B, T = cfg["batch_size"], cfg["window_t"]
        self.B, self.T = B, T
        self.X, self.Y = make_windows(traffic["train_batches"] * B, cfg, seed, 0)
        self.Xv, self.Yv = make_windows(traffic["val_batches"] * B, cfg, seed, 1)
        self.shuffle = np.random.default_rng([seed, 2])
        self.tr = build(cfg, seed, self.device)
        # the first train and eval steps, kept for ``check``
        self.rng0 = self.tr.dropout_generator.get_state()
        self.first_batches = ((self.X[:B].copy(), self.Y[:B].copy()),
                              (self.Xv[:B].copy(), self.Yv[:B].copy()))
        params = list(self.tr.module.parameters())
        p0 = [p.detach().clone() for p in params]
        losses, _ = self.tr.train_epoch(*self.first_batches[0], B)
        grads = [p.grad.detach().clone() for p in params]
        changes = [p.detach() - q for p, q in zip(params, p0)]
        del p0
        held = []
        hook = self.tr.module.Linear.register_forward_hook(
            lambda m, i, out: held.append(out[:, -1].detach().clone()))
        try:
            self.tr.val_epoch(*self.first_batches[1], B)
        finally:
            hook.remove()
        self.first = {"loss": losses[0], "grads": grads, "changes": changes,
                      "logits": held[0]}
        self.steps = {"train": 0, "eval": 0}
        self.frames = 0
        self.failed = 0
        self.elapsed = None
        self.check_cycle = int(np.random.default_rng([seed, 3]).integers(2))
        self.cycles = 0
        self.checked = None  # (state before, X, Y, losses, weights after)
        self.opt_steps = None

    def _count(self, kind, n, failed):
        self.steps[kind] += n
        self.frames += n * self.B * self.T
        self.failed += int(failed)

    def _state(self):
        """The trainer's state for a replay (``reference.classifier.Trainer
        .from_state``), copied on the device."""
        params = list(self.tr.module.parameters())
        held = [self.tr.opt.state.get(p, {}) for p in params]
        # an optimizer that took no step holds no state: its moments are 0
        return {"weights": [p.detach().clone() for p in params],
                "adam": [(s["exp_avg"].clone(), s["exp_avg_sq"].clone()) if "exp_avg" in s
                         else (torch.zeros_like(p), torch.zeros_like(p))
                         for p, s in zip(params, held)],
                "step": float(held[0].get("step", 0)),
                "rng": self.tr.dropout_generator.get_state()}

    def cycle(self):
        with self.rec.span("cycle"):
            checked = self.cycles == self.check_cycle and self.checked is None
            before = self._state() if checked else None
            X, Y = self.X, self.Y
            with self.rec.span("train_epoch"):
                losses, _ = self.tr.train_epoch(X, Y, self.B)
            self._count("train", len(losses), sum(not np.isfinite(v) for v in losses))
            if checked:
                self.checked = (before, X, Y, losses,
                                [p.detach().clone() for p in self.tr.module.parameters()])
            with self.rec.span("val_epoch"):
                loss, _, _ = self.tr.val_epoch(self.Xv, self.Yv, self.B)
            n = self.Xv.shape[0] // self.B
            self._count("eval", n, 0 if np.isfinite(loss) else n)  # one sum for the epoch
            order = self.shuffle.permutation(X.shape[0])  # run_epochs' reshuffle
            self.X, self.Y = X[order], Y[order]
        self.cycles += 1

    def window(self, seconds):
        t0 = time.perf_counter()
        while True:
            self.cycle()
            if time.perf_counter() - t0 >= seconds and self.cycles > self.check_cycle:
                break
        self.elapsed = time.perf_counter() - t0
        self.window_steps = dict(self.steps)  # a traced unit runs more
        held = [float(s["step"]) for s in self.tr.opt.state.values() if "step" in s]
        self.opt_steps = (held[0] if held else 0.0) - 1  # less the first step's

    def traced_unit(self):
        frames = self.frames
        profiling.enable()
        try:
            self.cycle()
        finally:
            profiling.disable()
        held = profiling.snapshot()
        out = {"frames": self.frames - frames}
        steps = sum(held["spans"].get(name, {}).get("n", 0)
                    for name in ("classif.train_step", "classif.eval_step"))
        if steps and "classif.rnn_calls" in held["counts"]:
            out["rnn_calls"] = held["counts"]["classif.rnn_calls"]
            out["rnn_steps"] = steps
        return out

    @property
    def attempted(self):
        return sum(self.window_steps.values())

    def end_to_end(self):
        return {"train_frames_per_s": self.frames / self.elapsed}

    def layer_counts(self):
        """The window's counts; its operations from the configuration's
        shapes."""
        flops = sum(n * ref.step_flops(self.cfg, kind, self.B, self.T)
                    for kind, n in self.window_steps.items())
        return {"classif_train_steps": self.window_steps["train"], "window_s": self.elapsed,
                "flops": flops}

    def free(self):
        del self.tr
        self.X = self.Y = self.Xv = self.Yv = None  # the checked epoch keeps its rows

    def _program_epoch(self):
        before, _, _, losses, after = self.checked
        return {"losses": losses, "changes": [a - b for a, b in zip(after, before["weights"])]}

    def _replay(self, **kwargs):
        before, X, Y, _, _ = self.checked
        return ref.replay_epoch(self.cfg, before, X, Y, self.B, self.device, **kwargs)

    def _first(self, **kwargs):
        train, val = self.first_batches
        return ref.first_steps(self.cfg, self.seed, self.rng0, train, val, self.device, **kwargs)

    def _steps_missing(self):
        """Steps Adam's counter lacks, or holds beyond, against the window's
        train steps as the harness counted them; exact."""
        return ("steps_missing", float(abs(self.opt_steps - self.window_steps["train"])))

    def check(self):
        """The first train and eval steps and the window's checked epoch
        against the plain reference in float64, and Adam's step counter."""
        first = judge_first_steps(self.first, self._first())
        return first + judge_epoch(self._program_epoch(), self._replay()) + [self._steps_missing()]


def judge_first_steps(prog, ref_steps):
    """[(name, value)]: the train step's relative loss gap; the worst leaf's
    gap of the gradients' and of the change's norms (``compare.worst_leaf``);
    the eval step's largest logit gap over the largest logit."""
    loss_gap = abs(prog["loss"] - ref_steps["loss"]) / abs(ref_steps["loss"])
    grads = ref_steps["grads"]
    logits, want = prog["logits"].cpu(), ref_steps["logits"].cpu()
    eval_gap = compare.relative_max(logits, want) if logits.shape == want.shape else math.inf
    return [("loss_gap", loss_gap),
            ("grad_gap", compare.worst_leaf(prog["grads"], grads, grads)),
            ("step_gap", compare.worst_leaf(prog["changes"], ref_steps["changes"], grads)),
            ("eval_gap", eval_gap)]


def judge_epoch(prog, replay):
    """[(name, value)]: the worst step's relative loss gap over the checked
    epoch, and the worst leaf's gap of the norms of the weights' change over
    it (leaves left out by the replay's first gradients)."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], replay["losses"],
                                                        strict=True))
    step_gap = compare.worst_leaf(prog["changes"], replay["changes"], replay["grads"])
    return [("epoch_loss_gap", loss_gap), ("epoch_step_gap", step_gap)]


FAULTS = {  # name: (faults of the reference, judged on the first steps too)
    "fault_half_batch": (("half_batch",), True),
    "fault_batch_twice": (("batch_twice",), False),
    "fault_shift_masks": (("shift_masks",), True),
    "fault_unreversed": (("unreversed",), True),
}


def calibrate(cell):
    """The readings a limit is set from, against one float64 reference: the
    program's; the control's (the reference in the program's place at
    float32 with TF32 on, the precision below what the configuration
    states); and the planted faults' (the reference at float32, TF32 off,
    with ``FAULTS``' faults), each first step from the seed and each replay
    from the program's state."""
    first, epoch = cell._first(), cell._replay()
    out = {"program": (judge_first_steps(cell.first, first)
                       + judge_epoch(cell._program_epoch(), epoch) + [cell._steps_missing()])}
    f32 = {"dtype": torch.float32}
    out["control"] = (judge_first_steps(cell._first(**f32, tf32=True), first)
                      + judge_epoch(cell._replay(**f32, tf32=True), epoch))
    for name, (faults, on_first) in FAULTS.items():
        got = judge_first_steps(cell._first(**f32, faults=faults), first) if on_first else []
        out[name] = got + judge_epoch(cell._replay(**f32, faults=faults), epoch)
    return out
