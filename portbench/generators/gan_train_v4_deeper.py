"""GAN training traffic of the deepest generator, v4_deeper with text:
``gan_train``'s schedule, set-up, window and checks, held against
``reference/models_v4_deeper``.

Importing the reference module registers its class, which the reference's
``build_generator`` and ``counts.generator_flops`` then find.  What differs
from ``gan_train``:

  * ``check``, ``_replays`` and ``calibrate`` use that module's
    ``first_steps`` and ``replay_epochs``, which record a parameter that got
    no gradient (the dead branch's) as zeros, as the program's side does;
  * ``layer_counts`` counts each G step's forward in train mode, dead branch
    included (``models_v4_deeper.step_flops``);
  * ``traced_unit`` turns the port's tracer on for the traced cycle alone
    and returns the totals of the span ``train.dead_branch``, the counter
    ``train.dead_branch_frames`` and the span ``train.g_step`` beside the
    cycle's frames.  The window runs with the tracer off.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils import profiling
from portbench.generators import gan_train
from portbench.generators.gan_train import judge_epochs, judge_first_steps
from portbench.reference import models_v4_deeper as ref

SPANS = gan_train.SPANS


class Cell(gan_train.Cell):
    def traced_unit(self):
        profiling.enable()
        try:
            out = super().traced_unit()
        finally:
            profiling.disable()
        held = profiling.snapshot()
        spans, counted = held["spans"], held["counts"]
        if "train.dead_branch" in spans:
            out["dead_branch_s"] = spans["train.dead_branch"]["seconds"]
            out["dead_branch_frames"] = counted.get("train.dead_branch_frames", 0)
        if "train.g_step" in spans:
            out["g_step_s"] = spans["train.g_step"]["seconds"]
        return out

    def layer_counts(self):
        out = super().layer_counts()
        out["flops"] = sum(n * ref.step_flops(self.cfg, kind, self.B if kind != "val" else self.Bv,
                                              self.T) for kind, n in self.window_steps.items())
        return out

    def _replays(self, **kwargs):
        out = {"losses": [], "grads": [], "changes": []}
        for before, epochs, _, _ in self.checked:
            net = "D" if epochs[0][0] == "d" else "G"
            r = ref.replay_epochs(self.cfg, before, epochs, self.device, **kwargs)
            out["losses"] += r["losses"]
            out["grads"] += r["grads"][net]
            out["changes"] += r["changes"][net]
        return out

    def check(self):
        r = ref.first_steps(self.cfg, self.seed, self.batches, self.device)
        return (judge_first_steps(self.first, r)
                + judge_epochs(self._program_epochs(), self._replays())
                + [self._steps_missing()])


@contextmanager
def without_dead_branch():
    """The reference with its train-mode dead branch skipped: a planted
    fault, the program that drops the branch (and with it the branch's
    dropout draws, which shifts every later mask)."""
    cls = ref.regressor_fcn_bn_32_v4_deeper
    kept = cls.dead_branch
    cls.dead_branch = lambda self, seventh, feats: None
    try:
        yield
    finally:
        cls.dead_branch = kept


def calibrate(cell):
    """``gan_train.calibrate``'s readings (the program, the TF32 control,
    the half-batch and batch-twice faults) against this model's reference,
    and one more fault's: the reference at float32 with the dead branch
    skipped (``without_dead_branch``)."""
    cfg, seed, dev = cell.cfg, cell.seed, cell.device
    r = ref.first_steps(cfg, seed, cell.batches, dev)

    def as_prog(s):
        return {"losses": s["losses"], "grads": s["grads"]["G"] + s["grads"]["D"],
                "changes": s["changes"]["G"] + s["changes"]["D"]}

    control = ref.first_steps(cfg, seed, cell.batches, dev, torch.float32, tf32=True)
    half = ref.first_steps(cfg, seed, cell.batches, dev, torch.float32, half_batch=True)
    epochs = cell._replays()
    f32 = {"dtype": torch.float32}
    with without_dead_branch():
        skipped = ref.first_steps(cfg, seed, cell.batches, dev, torch.float32)
        skipped_epochs = cell._replays(**f32)
    return {"program": (judge_first_steps(cell.first, r)
                        + judge_epochs(cell._program_epochs(), epochs)
                        + [cell._steps_missing()]),
            "control": (judge_first_steps(as_prog(control), r)
                        + judge_epochs(cell._replays(**f32, tf32=True), epochs)),
            "fault_half_batch": (judge_first_steps(as_prog(half), r)
                                 + judge_epochs(cell._replays(**f32, half_batch=True), epochs)),
            "fault_batch_twice": judge_epochs(cell._replays(**f32, batch_twice=True), epochs),
            "fault_no_dead_branch": (judge_first_steps(as_prog(skipped), r)
                                     + judge_epochs(skipped_epochs, epochs))}
