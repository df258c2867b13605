"""Lift-and-enhance traffic: ``process_dataset --lift``'s chain on partitions
of a split, then the enhancement forward, through the port's entry points.

A unit is one partition of sentence clips of OpenPose-like 2D keypoints
(x and y uniform over the image, confidence uniform over a range; in an
assumed share of frames, runs of a few frames whose first eight joints'
confidence falls below the prune threshold).  The clip lengths are one fixed
multiset drawn from the traffic's own seed, lognormal and clipped, the same
in every partition and every run; ``--seed`` orders them and draws the
keypoints.  Each partition runs:

  1. ``lifting.engine.lift_clips`` (pack, initialization, the ``filter_sgd``
     kernel; span ``lift``);
  2. ``ops.kinematics.xyz_to_aa``, ``ops.rotations.aa_to_rot6d``,
     ``data.windows.make_equal_len`` (cutting+reflect, 192) and the
     standardization of the arm columns (span ``convert``);
  3. ``infer.run_inference`` of the configuration's generator at the traffic's
     batch, float32, and the de-standardization (span ``forward``).

Set-up makes the partitions, builds the generator from the seed, and runs the
last partition through the chain: it warms every shape the window runs, and
its windows give the standardization statistics.  The window runs whole
partitions until ``seconds`` have passed.
What ``check`` judges is a sample of clips drawn from the seed among those the
window finished, with the longest among them.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data import windows
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.infer import run_inference
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.lifting import engine
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models import registry
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops import (
    filter_sgd,
    kinematics,
    rotations,
)
from portbench.generators import stats
from portbench.harness import compare, counts
from portbench.reference import convert as ref_convert
from portbench.reference import gan as ref_gan
from portbench.reference import lifting as ref_lifting
from portbench.reference import models as ref_models

SPANS = ("lift", "convert", "forward", "partition")


def clip_lengths(traffic, n):
    """The fixed multiset of ``n`` clip lengths (traffic's own seed)."""
    rng = np.random.RandomState(traffic["lengths_seed"])
    raw = rng.lognormal(np.log(traffic["length_median"]), traffic["length_sigma"], size=n)
    return np.clip(np.rint(raw), traffic["length_min"], traffic["length_max"]).astype(int)


def make_clips(traffic, lengths, gen, device):
    """OpenPose-like (T, 150) clips: x, y uniform over ``xy_range``,
    confidence uniform over ``confidence_range``; about ``pruned_share`` of
    the frames, in runs of ``pruned_run`` frames, get the first eight joints'
    confidence from ``pruned_confidence``, below the prune threshold."""
    total = int(lengths.sum())
    lo, hi = traffic["xy_range"]
    kp = torch.rand((total, 50, 3), generator=gen, device=device) * (hi - lo) + lo
    clo, chi = traffic["confidence_range"]
    kp[:, :, 2] = torch.rand((total, 50), generator=gen, device=device) * (chi - clo) + clo
    kp = kp.reshape(total, 150).cpu().numpy()
    r_lo, r_hi = traffic["pruned_run"]
    mean_run = (r_lo + r_hi) / 2
    n_runs = int(round(traffic["pruned_share"] * total / mean_run))
    picks = torch.randint(0, total, (n_runs,), generator=gen, device=device).cpu().numpy()
    runs = torch.randint(r_lo, r_hi + 1, (n_runs,), generator=gen, device=device).cpu().numpy()
    plo, phi = traffic["pruned_confidence"]
    for start, run in zip(picks, runs):
        sl = slice(start, min(start + run, total))
        k = sl.stop - sl.start
        conf = torch.rand((k, 8), generator=gen, device=device).cpu().numpy()
        kp[sl, 2:24:3] = conf * (phi - plo) + plo
    return np.split(kp, np.cumsum(lengths)[:-1])


class Cell:
    def __init__(self, cfg, traffic, seed, device, rec):
        self.cfg, self.traffic, self.seed, self.rec = cfg, traffic, seed, rec
        self.device = torch.device(device)
        n = traffic["clips_per_partition"]
        lengths = clip_lengths(traffic, n)
        rng = np.random.default_rng(seed)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.partitions = [make_clips(traffic, rng.permutation(lengths), gen, self.device)
                           for _ in range(traffic["partitions"])]
        self.model = registry.build_generator(
            cfg["model"], cfg["feature_in_dim"], cfg["feature_out_dim"],
            require_text=cfg["require_text"], default_size=cfg["default_size"],
            dropout_rate=cfg["dropout"], seed=seed, device=self.device)
        self.x_cols, self.y_cols = windows.pipeline_column_slices(cfg["pipeline"])
        self.unit_frames = int(lengths.sum())
        # warm-up: the last partition through the chain (the first partition
        # run otherwise pays ~1.5 s of first touches inside the window); the
        # standardization statistics come from its windows
        w = self._windows(self._lift(self.partitions[-1]))
        self.stats = stats.Standardization(w[:, :, self.x_cols], w[:, :, self.y_cols],
                                           cfg["pipeline"])
        run_inference(self.model, self.stats.apply(w[:, :, self.x_cols]),
                      batch_size=traffic["batch"], num_samples=len(w), device=self.device)
        self.sample_rng = np.random.default_rng(seed + 1)
        self.sample, self.longest = [], None
        self.seen = 0
        self.failed = self.attempted = self.units = 0
        self.elapsed = None

    def _lift(self, clips):
        return engine.lift_clips(clips, n_cycles=self.traffic["n_cycles"],
                                 t_bucket=self.traffic["t_bucket"],
                                 max_batch=self.traffic["max_batch"], device=self.device)

    def _windows(self, xyz):
        aa = kinematics.xyz_to_aa(xyz, device=self.device)
        r6d = rotations.aa_to_rot6d(aa, device=self.device)
        return windows.make_equal_len(r6d, method="cutting+reflect")

    def partition(self, clips):
        """One unit through the chain; returns the lifted xyz, the windows,
        the standardized inputs and the generator's outputs."""
        with self.rec.span("partition"):
            with self.rec.span("lift"):
                xyz = self._lift(clips)
            with self.rec.span("convert"):
                win = self._windows(xyz)
                Xs = self.stats.apply(win[:, :, self.x_cols])
            with self.rec.span("forward"):
                out, _ = run_inference(self.model, Xs, batch_size=self.traffic["batch"],
                                       num_samples=len(Xs), device=self.device)
                self.stats.restore(out)  # the enhanced windows a user keeps
        self.rec.add("input_frames", int(sum(c.shape[0] for c in clips)))
        return xyz, win, Xs, out

    def _keep(self, clips, xyz, win, Xs, out):
        """Count the clips that came out non-finite; reservoir-sample the
        finished clips (seeded) and keep the longest, copying only what is
        kept (a view would hold the whole partition's arrays)."""
        k = self.traffic["sample_clips"]
        bad = ~np.isfinite(out).all(axis=(1, 2))
        for i, c in enumerate(clips):
            self.failed += int(bad[i] or not np.isfinite(xyz[i]).all())
            self.seen += 1
            slot = len(self.sample) if len(self.sample) < k else self.sample_rng.integers(self.seen)
            longest = self.longest is None or c.shape[0] > self.longest[0].shape[0]
            if slot >= k and not longest:
                continue
            item = (c, xyz[i].copy(), win[i].copy(), Xs[i].copy(), out[i].copy())
            if longest:
                self.longest = item
            if slot == len(self.sample):
                self.sample.append(item)
            elif slot < k:
                self.sample[slot] = item

    def window(self, seconds):
        t0 = time.perf_counter()
        while True:
            clips = self.partitions[self.units % len(self.partitions)]
            res = self.partition(clips)
            self.units += 1
            self.attempted += len(clips)
            self._keep(clips, *res)
            if time.perf_counter() - t0 >= seconds:
                break
        self.elapsed = time.perf_counter() - t0

    def traced_unit(self):
        clips = self.partitions[self.units % len(self.partitions)]
        before = filter_sgd.filter_sgd.launches
        self.partition(clips)
        frames = int(sum(c.shape[0] for c in clips))
        live = 50 * frames
        return {"frames": frames, "filter_launches": filter_sgd.filter_sgd.launches - before,
                "filter_bound_s": counts.filter_bound_s(live, self.traffic["n_cycles"])}

    def end_to_end(self):
        return {"lift_frames_per_s": self.rec.counts["input_frames"] / self.elapsed}

    def layer_counts(self):
        """The window's counts; a partition's operations, the same in every
        one (its clips' forward and filter), counted once the window has
        closed."""
        n = self.traffic["clips_per_partition"]
        unit = (counts.generator_flops(self.cfg, n, ref_convert.WINDOW_T)
                + counts.filter_flops(50 * self.unit_frames, self.traffic["n_cycles"]))
        return {"window_s": self.elapsed, "flops": self.units * unit}

    def free(self):
        del self.model
        self.partitions = None

    def evidence(self):
        items = list(self.sample)
        if not any(it[0] is self.longest[0] for it in items):
            items.append(self.longest)
        return items

    def check(self):
        return judge(self.cfg, self.traffic, self.seed, self.evidence(), self.device)


def judge(cfg, traffic, seed, items, device, dtype=torch.float64):
    """[(name, value)], stage by stage against the plain reference in
    ``dtype``, each stage from the input the program's stage had: the lifting
    from the 2D clips (the worst clip's MPJPE), the conversion from the lifted
    xyz (the largest r6d gap; a non-finite entry counts as 2, the widest gap
    two entries of unit columns can have), the generator's forward from the
    standardized windows (the largest output gap over the largest reference
    output)."""
    clips, xyz, win, Xs, out = (list(z) for z in zip(*items))
    ref_xyz = ref_lifting.lift(clips, traffic["n_cycles"], device, dtype)
    lift_gap = max(compare.mpjpe(a, b) for a, b in zip(xyz, ref_xyz))
    gap = np.abs(np.stack(win) - ref_convert.xyz_to_windows(xyz, device, dtype))
    convert_gap = float(np.where(np.isfinite(gap), gap, 2.0).max())
    forward_gap = compare.relative_max(np.stack(out), forward(cfg, seed, Xs, device, dtype))
    return [("lift_mpjpe", lift_gap), ("convert_gap", convert_gap), ("forward_gap", forward_gap)]


def forward(cfg, seed, Xs, device, dtype, tf32=False):
    """The reference generator's output on standardized windows."""
    net = ref_models.build_generator(cfg, seed, dtype, device)
    with torch.no_grad(), ref_gan.precision(tf32):
        x = torch.from_numpy(np.stack(Xs)).to(device, dtype).transpose(1, 2)
        return net(x).transpose(1, 2).cpu().numpy()


def calibrate(cell):
    """The program's readings, and the control's: the reference in the
    place of each stage, from the input the program's stage had, a precision
    below what the stage states: the lifting and the conversion in bfloat16
    (float32 elementwise work), the forward in float32 with TF32 on (float32
    convolutions with TF32 off)."""
    items = cell.evidence()
    cfg, traffic, seed, dev = cell.cfg, cell.traffic, cell.seed, cell.device
    clips, xyz, _, Xs, _ = (list(z) for z in zip(*items))
    control = list(zip(
        clips, ref_lifting.lift(clips, traffic["n_cycles"], dev, torch.bfloat16), list(
            ref_convert.xyz_to_windows(xyz, dev, torch.bfloat16)),
        Xs, list(forward(cfg, seed, Xs, dev, torch.float32, tf32=True))))
    return {"program": judge(cfg, traffic, seed, items, dev),
            "control": judge(cfg, traffic, seed, control, dev)}
