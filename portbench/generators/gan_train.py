"""GAN training traffic: ``train_gan``'s epoch schedule through the port's
``GanTrainer.run_epoch``, with host-fed batches as the CLI runs it without
``--epoch_scan``.

Set-up makes a seeded pool of training windows and one of validation windows
on the host (and a 512-d text vector per window for a text-conditioned
configuration), builds the trainer from the seed, and drives its first three
steps, one of each kind (``FIRST_STEPS``), through
``run_epoch`` on rows that all differ: they warm up every shape the window
runs, and their losses, the gradients the optimizers got and the parameters'
change are what ``check`` holds against the plain reference. The D step goes
first, so both optimizers' first gradients come from the seeded weights: a G
step first would move G by about lr x sign(g), and its gradients' float32
rounding would flip the sign of the smallest, which D's gradient then reads.
The window runs whole cycles of the schedule's steady state (a D epoch, then
two G epochs each followed by a validation epoch at half batch, as
``epochs_train_disc`` = 3 makes it), the training pool reshuffled on the
host after every epoch, until ``seconds`` have passed.  In one of its first
two cycles, drawn from the seed, it takes the trainer's state (weights,
buffers, Adam's moments and step, the dropout generator) before the D epoch
and before one of the two G epochs, drawn too, and the parameters after
each; ``check`` has the reference replay those epochs, all their batches,
from those states and holds the epochs' losses and the parameters' change
against the program's.  It also holds the optimizers' step counters against
the steps the harness counted.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops.robust_loss import (
    robust_lossfun,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.train.gan import (
    GanConfig,
    GanTrainer,
)
from portbench.harness import compare, counts
from portbench.reference import gan as ref_gan

SPANS = ("g_epoch", "d_epoch", "val_epoch", "cycle")
# a cycle of the window: the epochs of each slot, in order
SCHEDULE = (("d",), ("g", "val"), ("g", "val"))
# the first steps' order: D first, so both optimizers' first gradients come
# from the seeded weights (module docstring)
FIRST_STEPS = ("d", "g", "val")


def make_pool(n, cfg, seed, device, offset):
    """(X, Y, text or None): n standard-normal windows (as standardized r6d
    is), drawn on the device from the seed and kept on the host."""
    gen = torch.Generator(device=device).manual_seed(seed + offset)
    T = cfg["window_t"]

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=device).cpu().numpy()

    X, Y = draw(n, T, cfg["feature_in_dim"]), draw(n, T, cfg["feature_out_dim"])
    F = draw(n, 512) if cfg["require_text"] else None
    return X, Y, F


def gan_config(cfg, seed):
    return GanConfig(
        model=cfg["model"], pipeline=cfg["pipeline"], feature_in_dim=cfg["feature_in_dim"],
        feature_out_dim=cfg["feature_out_dim"], batch_size=cfg["batch_size"],
        learning_rate=cfg["learning_rate"], epochs_train_disc=cfg["epochs_train_disc"],
        disc_label_smooth=cfg["disc_label_smooth"], loss=cfg["loss"],
        require_text=cfg["require_text"], default_size=cfg["default_size"], seed=seed,
        window_t=cfg["window_t"], dropout_rate=cfg["dropout"])


def _rows(arrays, sl):
    return tuple(None if a is None else a[sl] for a in arrays)


class Cell:
    def __init__(self, cfg, traffic, seed, device, rec):
        self.cfg, self.seed, self.device, self.rec = cfg, seed, torch.device(device), rec
        B, T = cfg["batch_size"], cfg["window_t"]
        self.B, self.Bv, self.T = B, B // 2, T
        self.train = make_pool(traffic["train_batches"] * B, cfg, seed, self.device, 0)
        self.val = make_pool(traffic["val_batches"] * self.Bv, cfg, seed, self.device, 1)
        self.shuffle = np.random.default_rng(seed)
        self.tr = GanTrainer(gan_config(cfg, seed), device=self.device)
        tr = self.tr
        g_params = list(tr.generator.parameters())
        d_params = list(tr.discriminator.parameters())
        p0 = [p.detach().clone() for p in g_params + d_params]
        # the first steps: one of each kind, on rows that all differ
        rows = {"g": _rows(self.train, slice(0, B)), "d": _rows(self.train, slice(B, 2 * B)),
                "val": _rows(self.val, slice(0, self.Bv))}
        self.batches = {kind: rows[kind] for kind in FIRST_STEPS}
        losses, grads = [], {}
        for kind in FIRST_STEPS:
            x, y, f = self.batches[kind]
            losses.append(tr.run_epoch(x, y, kind, x.shape[0], f))
            if kind != "val":
                opt, params = (tr.g_opt, g_params) if kind == "g" else (tr.d_opt, d_params)
                beta1 = opt.param_groups[0]["betas"][0]
                # Adam's first moment after one step is (1 - beta1) g; an
                # optimizer that took no step holds no state: it got nothing
                grads[kind] = [(opt.state[p]["exp_avg"] / (1 - beta1)).cpu()
                               if "exp_avg" in opt.state[p] else torch.zeros_like(p).cpu()
                               for p in params]
        changes = [(p.detach() - q).cpu() for p, q in zip(g_params + d_params, p0)]
        self.first = {"losses": losses, "grads": grads["g"] + grads["d"], "changes": changes}
        self.steps = {"g": 0, "d": 0, "val": 0}
        self.frames = 0
        self.failed = 0
        self.elapsed = None
        # the window's epochs that ``check`` replays: in cycle ``check_cycle``,
        # slot 0 (the D epoch) and slot ``check_slot`` (a G epoch and its val)
        pick = np.random.default_rng([seed, 1])
        self.check_cycle, self.check_slot = int(pick.integers(2)), int(pick.integers(1, 3))
        self.cycles = 0
        self.checked = []  # [(state before, epochs run, losses, parameters after)]
        self.opt_steps = None

    def _epoch(self, kind):
        X, Y, F = self.train if kind != "val" else self.val
        B = self.B if kind != "val" else self.Bv
        with self.rec.span(f"{kind}_epoch"):
            loss = self.tr.run_epoch(X, Y, kind, B, F)
        n = X.shape[0] // B
        self.steps[kind] += n
        self.frames += n * B * self.T
        if not np.isfinite(loss):
            self.failed += n
        if kind != "val":  # the CLI reshuffles after every epoch
            order = self.shuffle.permutation(X.shape[0])
            self.train = tuple(None if a is None else a[order] for a in self.train)
        return loss, ((X, Y, F), B)

    def _state(self):
        """The trainer's state for a replay (``reference.gan.Steps.load``),
        copied on the device."""
        tr = self.tr

        def module(m):
            return [t.detach().clone() for t in list(m.parameters()) + list(m.buffers())]

        def adam(opt, m):
            held = [opt.state.get(p, {}) for p in m.parameters()]
            return [(s["exp_avg"].clone(), s["exp_avg_sq"].clone(), float(s["step"]))
                    if "exp_avg" in s else None for s in held]

        return {"G": module(tr.generator), "D": module(tr.discriminator),
                "g_opt": adam(tr.g_opt, tr.generator), "d_opt": adam(tr.d_opt, tr.discriminator),
                "rng": tr.dropout_generator.get_state()}

    def cycle(self):
        with self.rec.span("cycle"):
            for slot, kinds in enumerate(SCHEDULE):
                checked = self.cycles == self.check_cycle and slot in (0, self.check_slot)
                before = self._state() if checked else None
                run = [(kind, *self._epoch(kind)) for kind in kinds]
                if checked:
                    m = self.tr.discriminator if kinds[0] == "d" else self.tr.generator
                    self.checked.append((before, [(k, rows, B) for k, _, (rows, B) in run],
                                         [loss for _, loss, _ in run],
                                         [p.detach().clone() for p in m.parameters()]))
        self.cycles += 1

    def window(self, seconds):
        t0 = time.perf_counter()
        while True:
            self.cycle()
            if time.perf_counter() - t0 >= seconds and self.cycles > self.check_cycle:
                break
        self.elapsed = time.perf_counter() - t0
        self.window_steps = dict(self.steps)  # a traced unit runs more
        # Adam's step counters (one parameter's), less the first steps' one
        self.opt_steps = {}
        for kind, opt in (("g", self.tr.g_opt), ("d", self.tr.d_opt)):
            held = [float(s["step"]) for s in opt.state.values() if "step" in s]
            self.opt_steps[kind] = (held[0] if held else 0.0) - 1

    def traced_unit(self):
        before, frames = robust_lossfun.launches, self.frames
        self.cycle()
        out = {"frames": self.frames - frames}
        if self.cfg["loss"] == "RobustLoss":
            D = self.T * self.cfg["feature_out_dim"]
            n_g = 2 * (self.train[0].shape[0] // self.B)
            n_val = 2 * (self.val[0].shape[0] // self.Bv)
            out["robust_launches"] = robust_lossfun.launches - before
            out["robust_expected_launches"] = n_g + n_val
            out["robust_bound_s"] = (n_g * counts.robust_bound_s(self.B, D)
                                     + n_val * counts.robust_bound_s(self.Bv, D))
        return out

    @property
    def attempted(self):
        return sum(self.window_steps.values())

    def end_to_end(self):
        return {"train_frames_per_s": self.frames / self.elapsed}

    def layer_counts(self):
        """The window's counts; its operations from the configuration's
        shapes (counted once the window has closed: it is the yardstick's
        work, not the program's set-up)."""
        flops = sum(n * counts.step_flops(self.cfg, kind, self.B if kind != "val" else self.Bv,
                                          self.T) for kind, n in self.window_steps.items())
        return {"g_steps": self.window_steps["g"], "d_steps": self.window_steps["d"],
                "window_s": self.elapsed, "flops": flops}

    def free(self):
        del self.tr
        self.train = self.val = None  # the checked epochs keep their rows

    def _replays(self, **kwargs):
        """The reference's replay of each checked epoch from the program's
        state before it (float64 unless ``kwargs`` say otherwise), as one
        record: the epochs' losses, and the D epoch's change of D's
        parameters and the G epoch's of G's, with the first gradients."""
        out = {"losses": [], "grads": [], "changes": []}
        for before, epochs, _, _ in self.checked:
            net = "D" if epochs[0][0] == "d" else "G"
            r = ref_gan.replay_epochs(self.cfg, before, epochs, self.device, **kwargs)
            out["losses"] += r["losses"]
            out["grads"] += r["grads"][net]
            out["changes"] += r["changes"][net]
        return out

    def _program_epochs(self):
        return {"losses": [loss for _, _, losses, _ in self.checked for loss in losses],
                "changes": [a - b for before, epochs, _, after in self.checked
                            for a, b in zip(after, before["D" if epochs[0][0] == "d" else "G"])]}

    def _steps_missing(self):
        """Steps the optimizers' counters lack, or hold beyond, against the
        window's steps as the harness counted them; exact."""
        return ("steps_missing", float(sum(abs(self.opt_steps[k] - self.window_steps[k])
                                           for k in ("g", "d"))))

    def check(self):
        """The first three steps and the window's checked epochs against the
        plain reference in float64, and the optimizers' step counters."""
        ref = ref_gan.first_steps(self.cfg, self.seed, self.batches, self.device)
        return (judge_first_steps(self.first, ref)
                + judge_epochs(self._program_epochs(), self._replays())
                + [self._steps_missing()])


def judge_first_steps(prog, ref):
    """[(name, value)]: the worst step's relative loss gap, and the worst
    leaf's gap of the first gradients' and of the three steps' change's
    norms (``compare.worst_leaf``)."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    ref_grads = ref["grads"]["G"] + ref["grads"]["D"]
    grad_gap = compare.worst_leaf(prog["grads"], ref_grads, ref_grads)
    step_gap = compare.worst_leaf(prog["changes"], ref["changes"]["G"] + ref["changes"]["D"],
                                  ref_grads)
    return [("loss_gap", loss_gap), ("grad_gap", grad_gap), ("step_gap", step_gap)]


def judge_epochs(prog, ref):
    """[(name, value)]: the worst checked epoch's relative loss gap, and the
    worst leaf's gap of the norms of the parameters' change over its epoch
    (``compare.worst_leaf``, leaves left out by the replay's first
    gradients)."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"],
                                                        strict=True))
    step_gap = compare.worst_leaf(prog["changes"], ref["changes"], ref["grads"])
    return [("epoch_loss_gap", loss_gap), ("epoch_step_gap", step_gap)]


def calibrate(cell):
    """The readings a limit is set from, against one float64 reference: the
    program's; the control's (the reference in the program's place at
    float32 with TF32 on, the precision below what the configuration
    states); and two planted faults' (the reference at float32, TF32 off:
    each loss the mean over the first half of its batch; each replayed epoch
    feeding its first batch again in place of its second).  The program's
    checked epochs are replayed from the program's states, the control's and
    the faults' from the same states.  A step that leaves the state
    unchanged reads 1 on ``step_gap`` and ``epoch_step_gap`` and needs no
    run."""
    cfg, seed, dev = cell.cfg, cell.seed, cell.device
    ref = ref_gan.first_steps(cfg, seed, cell.batches, dev)

    def as_prog(r):
        return {"losses": r["losses"], "grads": r["grads"]["G"] + r["grads"]["D"],
                "changes": r["changes"]["G"] + r["changes"]["D"]}

    control = ref_gan.first_steps(cfg, seed, cell.batches, dev, torch.float32, tf32=True)
    half = ref_gan.first_steps(cfg, seed, cell.batches, dev, torch.float32, half_batch=True)
    epochs = cell._replays()
    f32 = {"dtype": torch.float32}
    return {"program": (judge_first_steps(cell.first, ref)
                        + judge_epochs(cell._program_epochs(), epochs)
                        + [cell._steps_missing()]),
            "control": (judge_first_steps(as_prog(control), ref)
                        + judge_epochs(cell._replays(**f32, tf32=True), epochs)),
            "fault_half_batch": (judge_first_steps(as_prog(half), ref)
                                 + judge_epochs(cell._replays(**f32, half_batch=True), epochs)),
            "fault_batch_twice": judge_epochs(cell._replays(**f32, batch_twice=True), epochs)}
