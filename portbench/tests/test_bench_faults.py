"""The comparison that decides ``correct`` sees the program's faults: a
sound run at a small size on the CPU comes out correct, and a run with the
timed path broken underneath comes out not correct, once for each fault the
cell can have (one chip: no exchange between chips to leave out)."""

from __future__ import annotations

import numpy as np
import pytest

from bench_small import small
from portbench import run
from portbench.generators import enhance, gan_train, lift_enhance
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.train.gan import GanTrainer

SEED = 2**31 + 7


def correct(cell):
    args = run.parse(["--workload", cell, "--seed", str(SEED), "--seconds", "0.05"])
    return run.run(args, device="cpu", cell_override=small)["correct"]


def _state_unchanged(monkeypatch, module):
    init = GanTrainer.__init__

    def patched(self, *a, **k):
        init(self, *a, **k)
        for opt in (self.g_opt, self.d_opt):
            opt.step = lambda *args, **kwargs: None

    monkeypatch.setattr(module.GanTrainer, "__init__", patched)


def _half_batch_training(monkeypatch, module):
    to_device = GanTrainer._to_device
    monkeypatch.setattr(module.GanTrainer, "_to_device",
                        lambda self, a: to_device(self, a[: len(a) // 2]))


def _batch_fed_twice(monkeypatch, module):
    """Every epoch feeds its first batch again in place of its second."""
    run_epoch = GanTrainer.run_epoch

    def fed_twice(self, X, Y, kind, batch_size, feats=None):
        def fed(a):
            if a is None or len(a) < 2 * batch_size:
                return a
            a = a.copy()
            a[batch_size:2 * batch_size] = a[:batch_size]
            return a

        return run_epoch(self, fed(X), fed(Y), kind, batch_size, fed(feats))

    monkeypatch.setattr(module.GanTrainer, "run_epoch", fed_twice)


def _adam_step_counter_stuck(monkeypatch, module):
    """Adam's step counter stays at 1 after the first step, so its bias
    correction is the first step's ever after."""
    init = GanTrainer.__init__

    def patched(self, *a, **k):
        init(self, *a, **k)
        for opt in (self.g_opt, self.d_opt):
            def step(*args, _step=opt.step, _opt=opt, **kwargs):
                _step(*args, **kwargs)
                for state in _opt.state.values():
                    state["step"].fill_(1.0)
            opt.step = step

    monkeypatch.setattr(module.GanTrainer, "__init__", patched)


def _half_batch_forward(monkeypatch, module):
    orig = module.run_inference

    def half(model, X, *args, **kwargs):
        out, err = orig(model, X[: len(X) // 2 + 1], *(a[: len(X) // 2 + 1] for a in args),
                        **{**kwargs, "num_samples": len(X) // 2 + 1})
        return np.concatenate([out, out])[: len(X)], err

    monkeypatch.setattr(module, "run_inference", half)


def _altered_output(monkeypatch, module):
    orig = module.run_inference

    def altered(*args, **kwargs):
        out, err = orig(*args, **kwargs)
        out = out.copy()
        out[-1, 0, 0] += 0.01 * np.abs(out).max()
        return out, err

    monkeypatch.setattr(module, "run_inference", altered)


def _altered_lifting(monkeypatch, module):
    orig = module.engine.lift_clips

    def altered(clips, *args, **kwargs):
        out = orig(clips, *args, **kwargs)
        out[-1] = out[-1][::-1].copy()  # one clip's frames in the wrong order
        return out

    monkeypatch.setattr(module.engine, "lift_clips", altered)


FAULTS = {
    "v1_arm2wh.train": (gan_train, [_state_unchanged, _half_batch_training, _batch_fed_twice,
                                    _adam_step_counter_stuck]),
    "v2_text_finger1_robust.train": (gan_train, [_state_unchanged, _half_batch_training,
                                                 _batch_fed_twice, _adam_step_counter_stuck]),
    "v1_arm2wh.lift_enhance": (lift_enhance, [_altered_lifting, _altered_output,
                                              _half_batch_forward]),
    "v2_text_finger1_robust.enhance": (enhance, [_altered_output, _half_batch_forward]),
}
CASES = [(cell, fault) for cell, (_, faults) in FAULTS.items() for fault in faults]


@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_sound_run_is_correct(cell):
    assert correct(cell)


@pytest.mark.parametrize("cell,fault", CASES, ids=[f"{c}-{f.__name__[1:]}" for c, f in CASES])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch, FAULTS[cell][0])
    assert not correct(cell)
