#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from ``csrc/`` (one nvcc per source,
started together; fails on a ``ptxas`` spill), holds each against its
plain PyTorch version on the card (``filter_sgd`` at the production
shapes and on every batch the lifting path below launches, with that
batch's own inputs, masked tails equal to x0 exactly; ``robust_loss`` at
the trainer's shapes with alpha exactly 0, exactly 2, spread over (1, 4)
and at 2 +- 1 ulp), then drives two paths through the port's entry points.

Serving: synthetic 2D keypoint clips (lengths 64-1920, from a seed) ->
``lift_clips`` (900 cycles, the ``filter_sgd`` kernel) -> xyz -> aa -> r6d
-> 192-frame windows -> the v1 ``arm2wh`` generator at full width (36 ->
252, default_size 256, seeded weights) -> ``save_results``.  The lifting
(shortest and longest clips), the generator's raw output and the result
xyz are checked against the port's CPU path.

Training: the r6d clips the lifting produced become the train and val
pickles of a temporary data directory, and the port's ``train_gan.main``
runs 4 epochs there at full width (batch 128, ``--loss RobustLoss
--disc_label_smooth``: epochs 0-2 train G and validate, epoch 3 trains D),
every regression loss through the ``robust_loss`` kernel; then
``run_inference`` from the checkpoint it saved.  Checked: finite losses,
the kernel's launch count, which parameters each epoch moved, the latents
bit for bit, one G and one D step on the card against the same step on the
CPU, and the checkpoint's strict reload.

Prints one line per phase, then a JSON line describing each kernel (with
its launch plan and, for the filter, its bound over the live elements and
its FP32 issue floor from the instructions counted in the built
library's SASS), the card's name and power limit (``nvidia-smi``), and as
the last line ``{"ok": true, "device": {...}}``.  Exits nonzero, with no
result line, on a machine without CUDA or when any phase fails.  Imports
nothing of JAX.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch import (
    infer,
    train_gan,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data import (
    io,
    standardize,
    windows,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.lifting import engine
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.losses.robust import (
    AdaptiveLossFunction,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models import registry
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops import (
    build,
    filter_sgd as fs,
    kinematics,
    robust_loss as rl,
    rotations,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.train import (
    checkpoint as ckpt_lib,
    data as data_lib,
    gan,
)

SEED = 0
N_CYCLES = 900
LR = 20.0
FILTER_ATOL = 2e-4  # the JAX package's filter tolerance, test_pallas_kernels.py:44
LIFT_ATOL = 2e-4  # x, y and per-joint error (tests/test_torch_lifting.py)
# z: the initialization is ill-conditioned there at float32, one ulp of the
# bone lengths moves it past 2e-4 (tests/test_torch_lifting.py,
# test_initialization_z_is_float32_noise)
LIFT_Z_ATOL = 2e-3
# the generator's raw output, card vs CPU, relative to its largest value:
# 2^-15 sits between float32 (24-bit mantissa) and TF32 (11 bits, about
# 2^-11 per product), so the check holds float32 and rejects TF32
FWD_REL_ATOL = 2.0**-15
MPJPE_BUDGET = 1e-3  # end-to-end budget, BASELINE.json
N_CLIPS = 512
N_CPU_WINDOWS = 256
# H100 SXM peaks (NVIDIA data sheet, 700 W): FP32 on the CUDA cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# FP32 instruction issue: 132 SMs x 128 lanes x 1.98 GHz boost
PEAK_FP32_INSTR = 132 * 128 * 1.98e9


def log(msg):
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=1):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def filter_inputs(rng, B, T, device):
    planes = [rng.randn(B, T, 50).astype(np.float32) for _ in range(5)]
    w = rng.rand(B, T, 50).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    # every fourth clip is short: a masked tail, as in a padded T-bucket
    for b in range(0, B, 4):
        mask[b, rng.randint(2, T) :] = 0.0
    w *= mask[:, :, None]
    return [torch.from_numpy(a).to(device) for a in (*planes, w, mask)]


def filter_fp32_per_element_cycle():
    """FP32 instructions per element and cycle of the filter's update, as
    built: those of the one-warp kernel's cycle loop (three SHFL.DOWN a
    cycle) in ``cuobjdump -sass`` of the library, over the K steps a lane
    holds.  The layout of rows over several warps runs the same update."""
    per_cycle = build.loop_fp32_per_cycle(
        build.sass("filter_sgd"), "filter_sgd_kernelILb0E", "SHFL.DOWN", 3)
    return per_cycle / fs.launch_plan(1, 1)[0]


def hold_filter(ins, rows, label, fp32, reps=10):
    """filter_sgd's wrapper against its plain version on the card, on the
    first ``rows`` rows of ``ins`` (the rest are the all-masked padding of
    a pow2 batch, which the plain version makes NaN); the masked tails of
    those rows must come out as x0 exactly.  ``fp32``: FP32 instructions
    per element and cycle, for the issue floor.  Returns the measured row."""
    B, T = ins[-1].shape
    got = fs.filter_sgd(*ins, LR, N_CYCLES)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    want = fs.filter_sgd_plain(*ins, LR, N_CYCLES)
    t1.record()
    torch.cuda.synchronize()
    err = max(float((g[:rows] - w[:rows]).abs().max()) for g, w in zip(got, want))
    masked = (ins[-1][:rows] == 0)[:, :, None].expand(-1, -1, 50)
    tails_exact = all(torch.equal(g[:rows][masked], x[:rows][masked])
                      for g, x in zip(got, ins[:3]))
    ms = cuda_ms(lambda: fs.filter_sgd(*ins, LR, N_CYCLES), reps=reps)
    elems = B * T * 50
    live = int(ins[-1].sum()) * 50  # the mask sum x 50 joints
    byte_s = (fs.BYTES_PER_ELEMENT * elems + 4 * B * T) / PEAK_BYTES
    flop_s = fs.FLOPS_PER_ELEMENT_CYCLE * elems * N_CYCLES / PEAK_FP32_FLOPS
    live_flop_s = fs.FLOPS_PER_ELEMENT_CYCLE * live * N_CYCLES / PEAK_FP32_FLOPS
    instr = fp32 * N_CYCLES / PEAK_FP32_INSTR
    row = {
        "inputs": label, "B": B, "T": T, "n_cycles": N_CYCLES,
        "launch_plan": dict(zip("KLWR", fs.launch_plan(B, T))),
        "max_abs_err": err, "masked_tails_exact": tails_exact,
        "ms": ms, "plain_ms": t0.elapsed_time(t1), "bound_ms": 1e3 * max(flop_s, byte_s),
        "bound_by": "operations" if flop_s >= byte_s else "bytes",
        "live_elements": live, "live_bound_ms": 1e3 * max(live_flop_s, byte_s),
        "issue_floor_ms": 1e3 * instr * elems, "live_issue_floor_ms": 1e3 * instr * live,
    }
    log("kernel filter_sgd " + json.dumps(row))
    if not (err <= FILTER_ATOL and tails_exact):
        raise AssertionError(f"filter_sgd disagrees with its plain version: {row}")
    return row


def kernel_phase(clips, fp32):
    """CUDA filter_sgd against its plain version at 900 cycles: at the
    production shapes B=128, T in {64, 256, 1920} (random planes, masked
    tails), then on every batch the lifting path launches for ``clips``,
    with that batch's own inputs (the engine's plan, packing and
    initialization).  Returns (production rows, path rows)."""
    rng = np.random.RandomState(SEED)
    prod = [hold_filter(filter_inputs(rng, 128, T, "cuda"), 128, "random", fp32)
            for T in (64, 256, 1920)]
    path = []
    for tb, chunk in engine._plan(clips):
        kps, masks, noises = (torch.from_numpy(a).to("cuda")
                              for a in engine._pack(chunk, tb))
        x0, y0, z0, Xx, Xy, Xw = engine._init_core(kps, masks, noises)
        path.append(hold_filter((x0, y0, z0, Xx, Xy, Xw, masks), len(chunk),
                                "path batch", fp32, reps=3))
    plans = sorted({tuple(r["launch_plan"].values()) for r in path})
    log(f"filter_sgd on the path's {len(path)} batches: launch plans (K, L, W, R) "
        f"{plans}, max_abs_err {max(r['max_abs_err'] for r in path):.3e}, kernel "
        f"{sum(r['ms'] for r in path):.3f} ms summed, bound "
        f"{sum(r['bound_ms'] for r in path):.3f} ms, live bound "
        f"{sum(r['live_bound_ms'] for r in path):.3f} ms, live issue floor "
        f"{sum(r['live_issue_floor_ms'] for r in path):.3f} ms, plain "
        f"{sum(r['plain_ms'] for r in path):.3f} ms")
    return prod, path


# robust loss, kernel vs plain: the JAX package's own tolerances
# (tests/test_pallas_kernels.py:108 for the loss, :122 for dx)
ROBUST_LOSS_TOL = (1e-5, 1e-6)  # rtol, atol
ROBUST_DX_TOL = (1e-4, 1e-6)
# (N, D): the G step's, the val step's and the article's batch of
# (B, 192 * 252) residuals, and one ragged shape
ROBUST_SHAPES = ((128, 48384), (64, 48384), (256, 48384), (7, 1000))


def robust_inputs(rng, N, D, device):
    """x ~ N(0, 1); c spread over (1e-3, 3); alpha by column, in groups of
    eight: exactly 0, exactly 2, four spread over (1, 4), and 2 +- 1 ulp.
    Returns (x, alpha, c, mask of the +-1 ulp columns)."""
    x = rng.randn(N, D).astype(np.float32)
    c = rng.uniform(1e-3, 3.0, size=(1, D)).astype(np.float32)
    alpha = rng.uniform(1.0, 4.0, size=(1, D)).astype(np.float32)
    col = np.arange(D) % 8
    alpha[0, col == 0] = 0.0
    alpha[0, col == 1] = 2.0
    two = np.float32(2.0)
    alpha[0, col == 6] = np.nextafter(two, np.float32(3.0))
    alpha[0, col == 7] = np.nextafter(two, np.float32(1.0))
    ulp = torch.from_numpy(col >= 6).to(device)
    return (*(torch.from_numpy(a).to(device) for a in (x, alpha, c)), ulp)


def _excess(got, want, tol, cols):
    """(max |got - want|, max of |got - want| / (atol + rtol |want|)) over
    the columns ``cols``."""
    rtol, atol = tol
    err = (got - want).abs()[:, cols]
    return float(err.max()), float((err / (atol + rtol * want.abs()[:, cols])).max())


def hold_robust(N, D, rng, reps=20):
    """The robust-loss kernel against its plain version on the card: loss
    and dx against ``robust_lossfun_plain`` and its autograd.  The columns
    with alpha = 2 +- 1 ulp are reported and not held: there the general
    branch is (eps / alpha)((u / eps + 1)^(alpha/2) - 1), a cancellation."""
    x, alpha, c, ulp = robust_inputs(rng, N, D, "cuda")
    loss, dx = rl.robust_loss_and_dx(x, alpha, c)
    xg = x.clone().requires_grad_(True)
    want = rl.robust_lossfun_plain(xg, alpha, c)
    (want_dx,) = torch.autograd.grad(want.sum(), xg)
    want = want.detach()
    torch.cuda.synchronize()
    if not (torch.isfinite(loss).all() and torch.isfinite(dx).all()):
        raise AssertionError(f"robust_loss kernel gave non-finite values at {(N, D)}")
    e_loss, x_loss = _excess(loss, want, ROBUST_LOSS_TOL, ~ulp)
    e_dx, x_dx = _excess(dx, want_dx, ROBUST_DX_TOL, ~ulp)
    u_loss, ux_loss = _excess(loss, want, ROBUST_LOSS_TOL, ulp)
    u_dx, ux_dx = _excess(dx, want_dx, ROBUST_DX_TOL, ulp)

    def plain():
        xp = x.clone().requires_grad_(True)
        torch.autograd.grad(rl.robust_lossfun_plain(xp, alpha, c).sum(), xp)

    # the wrapper's own host cost (~50 us) is of the kernel's order, so the
    # kernel's time is its device span under the profiler; the wrapper's
    # time between two events, host-bound at the small shapes, goes beside it
    wrapper_ms = cuda_ms(lambda: rl.robust_loss_and_dx(x, alpha, c), reps=reps)
    _, by_name = profiled(lambda: [rl.robust_loss_and_dx(x, alpha, c)
                                   for _ in range(reps)])
    spans = [v for k, v in by_name.items() if "robust_loss_kernel" in k]
    if not spans:
        raise AssertionError("the profiler saw no robust_loss_kernel span: "
                             f"{sorted(by_name)}")
    ms = 1e3 * sum(spans) / reps
    plain_ms = cuda_ms(plain, reps=3)
    byte_s = (rl.BYTES_PER_ELEMENT * N * D + 8 * D) / PEAK_BYTES
    flop_s = rl.FLOPS_PER_ELEMENT * N * D / PEAK_FP32_FLOPS
    row = {
        "N": N, "D": D, "max_abs_err": max(e_loss, e_dx),
        "loss_err_over_tol": x_loss, "dx_err_over_tol": x_dx,
        "ulp_columns": {"loss_abs_err": u_loss, "loss_err_over_tol": ux_loss,
                        "dx_abs_err": u_dx, "dx_err_over_tol": ux_dx},
        "launch_plan": {"path": rl.launch_path(x), "grid": rl.launch_grid(N, D)},
        "ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
        "bound_ms": 1e3 * max(byte_s, flop_s),
        "bound_by": "bytes" if byte_s >= flop_s else "operations",
    }
    log("kernel robust_loss " + json.dumps(row))
    if not (x_loss <= 1.0 and x_dx <= 1.0):
        raise AssertionError(f"robust_loss disagrees with its plain version: {row}")
    return row


def robust_kernel_phase():
    """Hold the robust-loss kernel at ``ROBUST_SHAPES``; also at
    the trainer's own parameters (alpha == 2, c == 0.5 in every column)."""
    rng = np.random.RandomState(SEED + 1)
    rows = [hold_robust(N, D, rng) for N, D in ROBUST_SHAPES]
    x = torch.from_numpy(rng.randn(128, 48384).astype(np.float32)).to("cuda")
    two = torch.full((1, 48384), 2.0, device="cuda")
    half = torch.full((1, 48384), 0.5, device="cuda")
    loss, dx = rl.robust_loss_and_dx(x, two, half)
    want = rl.robust_lossfun_plain(x, two, half)
    err = max(float((loss - want).abs().max()), float((dx - 4.0 * x).abs().max()))
    log(f"robust_loss at alpha == 2, c == 0.5, (128, 48384): max abs err {err:.3e}")
    if not err <= 1e-6 * float(want.max()):
        raise AssertionError("robust_loss off at the trainer's parameters")
    return rows


def ptxas_line(name):
    return " | ".join(
        ln.strip() for ln in build.build_log[name]["ptxas"].splitlines()
        if "registers" in ln or "spill" in ln)


def build_kernels(names):
    """Build every kernel (one nvcc per source, started together) and fail
    if ptxas reports a spill in any of them, or reports nothing (a library
    built earlier is read back with the report of its build)."""
    t0 = time.perf_counter()
    build.build(*names)

    def took(n):
        s = build.build_log[n]["seconds"]
        return "built earlier" if s is None else f"{s:.2f} s"

    log(f"build: {time.perf_counter() - t0:.2f} s for {len(names)} sources; "
        + "; ".join(f"{n} {took(n)}: {ptxas_line(n)}" for n in names))
    for n in names:
        report = build.build_log[n]["ptxas"]
        if "registers" not in report:
            raise AssertionError(f"no ptxas report for {n}.cu: {report!r}")
        spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", report)
        if any(int(v) for v in spills):
            raise AssertionError(f"ptxas reports spills in {n}.cu: {ptxas_line(n)}")


def synthetic_clips(rng, n):
    """OpenPose-like (T, 150) clips, T spread over 64..1920 (demo.py:65-67)."""
    lengths = rng.randint(64, 1921, size=n)
    clips = []
    for T in lengths:
        kp = rng.uniform(100, 500, size=(T, 150)).astype(np.float32)
        kp[:, 2::3] = rng.uniform(0.5, 1.0, size=(T, 50))
        clips.append(kp)
    return clips


def mpjpe(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm((a - b).reshape(*a.shape[:-1], 50, 3), axis=-1).mean())


def lift_close(gpu, cpu):
    """(max |dx|,|dy|), max |dz|, MPJPE between two lists of lifted clips."""
    g3 = np.concatenate([c.reshape(-1, 50, 3) for c in gpu])
    c3 = np.concatenate([c.reshape(-1, 50, 3) for c in cpu])
    d = np.abs(g3 - c3)
    return (float(d[..., :2].max()), float(d[..., 2].max()),
            float(np.linalg.norm(g3 - c3, axis=-1).mean()))


def lift_to_r6d(clips):
    """2D clips -> lifted xyz clips -> r6d clips, on the card."""
    frames = sum(c.shape[0] for c in clips)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xyz = engine.lift_clips(clips, n_cycles=N_CYCLES, device="cuda")
    torch.cuda.synchronize()
    lift_s = time.perf_counter() - t0
    log(f"lift: {len(clips)} clips, {frames} frames in {lift_s:.3f} s = "
        f"{frames / lift_s:.1f} frames/s, filter_sgd launches "
        f"{fs.filter_sgd.launches}")
    if not all(x.shape == c.shape and np.isfinite(x).all() for x, c in zip(xyz, clips)):
        raise AssertionError("lifted clips are not finite (T, 150) arrays")

    aa = kinematics.xyz_to_aa(xyz, device="cuda")
    return xyz, rotations.aa_to_rot6d(aa, device="cuda")


def path_phase(clips):
    """The serving chain on the card, checked against the CPU path; returns
    the filter_sgd launches of the main path and the r6d clips it made."""
    fs.filter_sgd.launches = 0  # counts of the main path start here
    xyz, r6d = lift_to_r6d(clips)
    win = windows.make_equal_len(r6d, method="cutting+reflect")
    X = win[:, :, :36].astype(np.float32)
    Y = win[:, :, 36:288].astype(np.float32)
    mX, sX, mY, sY = standardize.calc_standard(
        X.transpose(0, 2, 1), Y.transpose(0, 2, 1), "arm2wh")
    mX, sX, mY, sY = (a.transpose(0, 2, 1) for a in (mX, sX, mY, sY))
    Xs = ((X - mX) / sX).astype(np.float32)
    log(f"windows: X {X.shape} Y {Y.shape}")

    net = registry.build_generator("v1", 36, 252, default_size=256, seed=SEED,
                                   device="cuda")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        return _enhance_and_check(net, tmp, clips, xyz, X, Xs, sY, mY), r6d


def _enhance_and_check(net, tmp, clips, xyz, X, Xs, sY, mY):
    data_dir = os.path.join(tmp, "data")
    os.makedirs(data_dir)
    io.save_binary(xyz, os.path.join(data_dir, "xyz_train"))

    def enhance(device, precision, n, tag):
        """(raw generator output, result xyz) for the first n windows."""
        model = net if device == "cuda" else registry.build_generator(
            "v1", 36, 252, default_size=256, seed=SEED, device="cpu")
        raw, _ = infer.run_inference(model, Xs[:n], batch_size=128, num_samples=n,
                                     matmul_precision=precision, device=device)
        out = (raw * sY + mY).astype(np.float32)
        cwd = os.getcwd()
        os.chdir(tmp)  # save_results writes root.pkl / bone_len.pkl to the cwd
        try:
            path = infer.save_results(X[:n], out, "arm2wh", tmp, data_dir, tag=tag,
                                      infer_set="test", device=device)
        finally:
            os.chdir(cwd)
        return raw, np.asarray(io.load_binary(path))

    t0 = time.perf_counter()
    raw32, res32 = enhance("cuda", "float32", len(X), "gpu32")
    torch.cuda.synchronize()
    log(f"enhance + save_results (cuda, float32): {len(X)} windows in "
        f"{time.perf_counter() - t0:.3f} s")
    launches = fs.filter_sgd.launches  # end of the main path
    if launches <= 0:
        raise AssertionError("the lifting path never launched filter_sgd")
    if res32.shape != (len(X), 192, 150) or not np.isfinite(res32).all():
        raise AssertionError(f"bad result xyz {res32.shape}")
    raw_tf32, res_tf32 = enhance("cuda", "tensorfloat32", len(X), "gpu_tf32")

    # forward throughput at B=2048, T=192
    xb = torch.from_numpy(np.resize(Xs, (2048, 192, 36))).to("cuda").transpose(1, 2)
    with torch.no_grad():
        for precision in ("float32", "tensorfloat32"):
            with infer.conv_matmul_precision(precision):
                ms = cuda_ms(lambda: net(xb), reps=5)
            log(f"v1 forward B=2048 T=192 {precision}: {ms:.3f} ms = "
                f"{2048 * 192 / ms * 1e3:.1f} frames/s")

    # the CPU path on the two shortest and the two longest clips: the
    # 1-step and the 4-step kernel templates of the path (its T=64..128 and
    # T=1920 buckets)
    by_len = sorted(range(len(clips)), key=lambda i: clips[i].shape[0])
    sub = by_len[:2] + by_len[-2:]
    cpu_xyz = engine.lift_clips([clips[i] for i in sub], n_cycles=N_CYCLES,
                                device="cpu")
    dxy, dz, lift_mpjpe = lift_close([xyz[i] for i in sub], cpu_xyz)
    log(f"lift cuda vs cpu on {len(sub)} clips: max|dxy| {dxy:.3e} max|dz| {dz:.3e} "
        f"MPJPE {lift_mpjpe:.3e}")
    if not (dxy <= LIFT_ATOL and dz <= LIFT_Z_ATOL and lift_mpjpe <= LIFT_ATOL):
        raise AssertionError("lifting on the card disagrees with the CPU path")
    t0 = time.perf_counter()
    raw_cpu, res_cpu = enhance("cpu", "float32", N_CPU_WINDOWS, "cpu")
    log(f"enhance + save_results (cpu): {N_CPU_WINDOWS} windows in "
        f"{time.perf_counter() - t0:.3f} s")
    # the generator's raw output, before the de-standardization shrinks it
    atol = FWD_REL_ATOL * float(np.abs(raw_cpu).max())
    f32 = float(np.abs(raw32[:N_CPU_WINDOWS] - raw_cpu).max())
    tf32 = float(np.abs(raw_tf32[:N_CPU_WINDOWS] - raw_cpu).max())
    log(f"v1 raw output vs cpu: max abs err float32 {f32:.3e}, tensorfloat32 "
        f"{tf32:.3e} (atol {atol:.3e} = 2^-15 x max |out|)")
    if not f32 <= atol:
        raise AssertionError(f"float32 forward on the card off by {f32}")
    if not tf32 > atol:
        raise AssertionError("the raw-output check cannot tell TF32 from float32")
    m32 = mpjpe(res32[:N_CPU_WINDOWS], res_cpu)
    mtf = mpjpe(res_tf32[:N_CPU_WINDOWS], res_cpu)
    log(f"end-to-end xyz MPJPE vs cpu: float32 {m32:.3e}, tensorfloat32 {mtf:.3e} "
        f"(budget {MPJPE_BUDGET})")
    if not m32 <= MPJPE_BUDGET:
        raise AssertionError(f"float32 MPJPE {m32} over the budget")
    profile_phase(clips, Xs)
    return launches


# training phase: v1 arm2wh at full width, the reference's batch size
TRAIN_BATCH = 128
TRAIN_EPOCHS = 4  # epochs 0-2 train G and validate, epoch 3 trains D
N_VAL_CLIPS = 256
# One step on the card against the same step on the CPU, dropout 0, with
# cuDNN held to its deterministic algorithms for that step.  The loss is
# held relative, the running statistics absolute (the CPU tests' 5e-6,
# tests/test_torch_gan.py).  The generator's gradients are ill-conditioned
# at float32 (train-mode BatchNorm backward over channels of tiny variance):
# on these clips the CPU's float32 gradient is about 1% of the largest entry
# away from a float64 evaluation of the same step.  So the card's gradients
# are held against that float64 evaluation: they may be STEP_GRAD_FACTOR
# times as far from it as the CPU's float32 ones, no further.
# Adam's first update is lr * g / (|g| + eps), a sign: an entry whose
# float64 gradient is within STEP_NOISE_FACTOR of the CPU's float32 error in
# its tensor is noise at float32 and is masked, as the CPU tests mask
# 0 < |g| < 1e-6 at their loss of order 1.  The mask is built from the
# float64 step and the CPU's error alone: nothing the card computes widens
# it.  Outside the mask the card's and the CPU's parameters must agree to
# STEP_ATOL; inside it they may differ by the 2 * lr a flipped sign moves
# them, and no more; the mask's share is reported.
STEP_LOSS_RTOL = 1e-5
STEP_ATOL = 5e-6
STEP_GRAD_FACTOR = 2.0
STEP_NOISE_FACTOR = 4.0
STEP_LR = 1e-4  # GanConfig's default learning rate


def _snapshot(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _moved(module, before):
    """Did any parameter or running statistic differ from the snapshot?"""
    return any(not torch.equal(v, before[k]) for k, v in module.state_dict().items()
               if not k.endswith("num_batches_tracked"))


def _train_args(tmp, data_dir):
    return train_gan.build_parser().parse_args([
        "--base_path", tmp, "--data_dir", data_dir,
        "--model_path", os.path.join(tmp, "models"), "--exp_name", "smoke",
        "--num_epochs", str(TRAIN_EPOCHS), "--batch_size", str(TRAIN_BATCH),
        "--loss", "RobustLoss", "--disc_label_smooth", "--device", "cuda",
    ])


def _one_step(kind, x, y, device, dtype=torch.float32):
    """(loss, module stepped, its gradients) after one ``kind`` step from
    the seeded weights, dropout 0."""
    cfg = gan.GanConfig(loss="RobustLoss", disc_label_smooth=True,
                        batch_size=x.shape[0], dropout_rate=0.0)
    tr = gan.GanTrainer(cfg, device=device)
    for m in (tr.generator, tr.discriminator, tr.adaptive):
        m.to(dtype)
    before = rl.robust_lossfun.launches
    assert tr.cfg.learning_rate == STEP_LR
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        loss = float(tr._step(kind)(
            torch.from_numpy(x).to(device=device, dtype=dtype),
            torch.from_numpy(y).to(device=device, dtype=dtype)))
    finally:
        torch.backends.cudnn.deterministic = was
    if device == "cuda" and rl.robust_lossfun.launches != before + (kind == "g"):
        raise AssertionError(f"the card's {kind} step did not go through the kernel")
    module = tr.generator if kind == "g" else tr.discriminator
    grads = {k: p.grad.double().cpu() for k, p in module.named_parameters()}
    return loss, {k: v.cpu() for k, v in module.state_dict().items()}, grads


def step_against_cpu(kind, x, y):
    """One ``kind`` step ('g' or 'd') on the card, on the CPU, and on the
    CPU in float64, from the same seeded weights and batch.  Fails beyond
    the STEP_* tolerances; returns what came out."""
    loss_card, sd_card, g_card = _one_step(kind, x, y, "cuda")
    loss_cpu, sd_cpu, g_cpu = _one_step(kind, x, y, "cpu")
    _, _, g_ref = _one_step(kind, x, y, "cpu", torch.float64)
    worst = worst_masked = worst_stat = err_card = err_cpu = grad_max = 0.0
    masked = masked_fixed = total = 0
    for k, w in sd_cpu.items():
        if k.endswith("num_batches_tracked"):
            continue
        diff = (sd_card[k] - w).abs()
        if k not in g_ref:
            worst_stat = max(worst_stat, float(diff.max()))
            continue
        e_card = float((g_card[k] - g_ref[k]).abs().max())
        e_cpu = float((g_cpu[k] - g_ref[k]).abs().max())
        err_card, err_cpu = max(err_card, e_card), max(err_cpu, e_cpu)
        g = g_ref[k].abs()
        grad_max = max(grad_max, float(g.max()))
        keep = g >= STEP_NOISE_FACTOR * e_cpu
        total += keep.numel()
        masked += int((~keep).sum())
        masked_fixed += int(((g > 0) & (g < 1e-6)).sum())  # the CPU tests' mask
        worst = max(worst, float((diff * keep).max()))
        worst_masked = max(worst_masked, float((diff * ~keep).max()))
    row = {
        "step": kind, "loss_card": loss_card, "loss_cpu": loss_cpu,
        "loss_rel_err": abs(loss_card - loss_cpu) / max(abs(loss_cpu), 1e-30),
        "running_stat_err": worst_stat, "grad_abs_max": grad_max,
        "grad_err_card_vs_float64": err_card, "grad_err_cpu_vs_float64": err_cpu,
        "param_err_outside_mask": worst, "param_err_inside_mask": worst_masked,
        "masked_share": masked / total,
        "masked_share_of_1e-6_mask": masked_fixed / total,
    }
    log("step card vs cpu " + json.dumps(row))
    if not (row["loss_rel_err"] <= STEP_LOSS_RTOL and worst_stat <= STEP_ATOL
            and worst <= STEP_ATOL and worst_masked <= 2 * STEP_LR + STEP_ATOL
            and err_card <= STEP_GRAD_FACTOR * err_cpu):
        raise AssertionError(f"the card's {kind} step disagrees with the CPU's: {row}")
    return row


def timed_epochs(trainer, X, Y, kind, batch_size, resident, repeats=5,
                 deterministic=False):
    """Steps/s and frames/s of ``repeats`` epochs of one kind after one
    warm-up epoch; the host clock around work that ends in a synchronise.
    ``deterministic`` sets ``torch.backends.cudnn.deterministic`` meanwhile."""
    staged = trainer.stage(X, Y) if resident else None
    order = np.arange(len(X))

    def epoch():
        if resident:
            return trainer.run_epoch_resident(*staged, order, kind, batch_size)
        return trainer.run_epoch(X, Y, kind, batch_size)

    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    try:
        epoch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(repeats):
            epoch()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = was
    steps = repeats * (len(X) // batch_size)
    log(f"train rate {kind} epoch ({'resident' if resident else 'host batches'}, "
        f"B={batch_size}{', cudnn.deterministic' if deterministic else ''}): "
        f"{steps} steps in {dt:.3f} s = {steps / dt:.2f} steps/s, "
        f"{steps * batch_size * X.shape[1] / dt:.1f} frames/s")


def train_phase(r6d):
    """GAN training of v1 on the card through the port's CLI entry point,
    then inference from its checkpoint; returns the robust-loss launches of
    that run."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        data_dir = os.path.join(tmp, "data")
        os.makedirs(data_dir)
        io.save_binary(list(r6d), os.path.join(data_dir, "r6d_train"))
        io.save_binary(list(r6d[-N_VAL_CLIPS:]), os.path.join(data_dir, "r6d_val"))
        args = _train_args(tmp, data_dir)

        # weights are a function of the seed: the state before epoch 0
        first = gan.GanTrainer(gan.GanConfig(loss="RobustLoss"), device="cuda")
        state = {"g": _snapshot(first.generator), "d": _snapshot(first.discriminator),
                 "latents": _snapshot(first.adaptive)}
        del first
        seen = []

        def hook(epoch, kind, trainer, losses):
            if not all(np.isfinite(v) for v in losses.values()):
                raise AssertionError(f"epoch {epoch}: non-finite loss {losses}")
            g_moved = _moved(trainer.generator, state["g"])
            d_moved = _moved(trainer.discriminator, state["d"])
            if (g_moved, d_moved) != ((True, False) if kind == "g" else (False, True)):
                raise AssertionError(
                    f"epoch {epoch} ({kind}): generator moved {g_moved}, "
                    f"discriminator moved {d_moved}")
            if _moved(trainer.adaptive, state["latents"]):
                raise AssertionError(f"epoch {epoch}: the robust latents moved")
            state["g"] = _snapshot(trainer.generator)
            state["d"] = _snapshot(trainer.discriminator)
            seen.append((epoch, kind, losses))

        rl.robust_lossfun.launches = 0  # counts of the training path start here
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        best = train_gan.main(args, epoch_hook=hook)
        torch.cuda.synchronize()
        launches = rl.robust_lossfun.launches  # end of the training path
        log(f"train_gan.main: {TRAIN_EPOCHS} epochs in {time.perf_counter() - t0:.3f} s, "
            f"best val {best:.6f}, robust_loss launches {launches}; "
            + "; ".join(f"epoch {e} {k} {json.dumps(l)}" for e, k, l in seen))

        data = data_lib.load_data(data_dir, "arm2wh", os.path.join(tmp, "stats"),
                                  "smoke", np.random.RandomState(23456), base_path=tmp)
        X, Y, vX, vY = (data[k] for k in ("train_X", "train_Y", "val_X", "val_Y"))
        g_batches = sum(k == "g" for _, k, _ in seen) * (len(X) // TRAIN_BATCH)
        val_batches = sum(k == "g" for _, k, _ in seen) * (len(vX) // (TRAIN_BATCH // 2))
        if [k for _, k, _ in seen] != ["g", "g", "g", "d"]:
            raise AssertionError(f"unexpected schedule {seen}")
        if launches != g_batches + val_batches or launches <= 0:
            raise AssertionError(
                f"robust_loss launched {launches} times for {g_batches} G and "
                f"{val_batches} val batches")

        # the checkpoint reloads strictly and serves
        ckpt = os.path.join(args.model_path, "lastCheckpoint_smoke.pth")
        net = registry.build_generator("v1", 36, 252, device="cuda")
        net.load_state_dict(ckpt_lib.load_generator_state(ckpt), strict=True)
        out, err = infer.run_inference(net, vX, batch_size=TRAIN_BATCH,
                                       num_samples=len(vX), test_Y=vY, device="cuda")
        log(f"inference from the trained checkpoint: {out.shape}, L1 {err:.6f}")
        if out.shape != vY.shape or not np.isfinite(out).all():
            raise AssertionError(f"bad output from the trained checkpoint {out.shape}")
        resumed = gan.GanTrainer(gan.GanConfig(loss="RobustLoss"), device="cuda")
        resumed.load_checkpoint_payload(ckpt_lib.load_checkpoint(ckpt, "cuda"))

    ad = AdaptiveLossFunction(252 * 192).to("cuda")
    log(f"default latents on the card: alpha == 2.0 exactly "
        f"{bool((ad.alpha() == 2.0).all())}, c == 0.5 exactly "
        f"{bool((ad.scale() == 0.5).all())}")

    step_against_cpu("g", X[:TRAIN_BATCH], Y[:TRAIN_BATCH])
    step_against_cpu("d", X[:TRAIN_BATCH], Y[:TRAIN_BATCH])

    trainer = gan.GanTrainer(gan.GanConfig(loss="RobustLoss", disc_label_smooth=True),
                             device="cuda")
    for kind, bs, a, b in (("g", TRAIN_BATCH, X, Y), ("d", TRAIN_BATCH, X, Y),
                           ("val", TRAIN_BATCH // 2, vX, vY)):
        for resident in (False, True):
            timed_epochs(trainer, a, b, kind, bs, resident)
    timed_epochs(trainer, X, Y, "g", TRAIN_BATCH, True, deterministic=True)
    timed_epochs(trainer, X, Y, "d", TRAIN_BATCH, True, deterministic=True)
    staged = trainer.stage(X, Y)
    log_trace(f"one G epoch, {len(X) // TRAIN_BATCH} steps of B={TRAIN_BATCH} (resident)",
              *profiled(lambda: trainer.run_epoch_resident(
                  *staged, np.arange(len(X)), "g", TRAIN_BATCH)), "robust_loss")
    return launches


def profiled(fn):
    """Run ``fn`` under torch.profiler: (wall s, {kernel name: device s}).
    The device-busy time is the sum of the values (one stream, so the CUDA
    kernel spans do not overlap)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() * 1e-6
    return wall, by_name


def log_trace(label, wall, by_name, kernel):
    """One line for a traced window: wall, device busy, idle share, the time
    in the kernels whose name holds ``kernel``, and the top five."""
    busy = sum(by_name.values())
    if busy <= 0:
        log(f"trace {label}: wall {wall:.3f} s; device time not measured "
            "(the profiler saw no CUDA kernels)")
        return
    own = sum(v for k, v in by_name.items() if kernel in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    log(f"trace {label}: wall {wall:.3f} s, device busy {busy:.3f} s "
        f"(idle share {1 - busy / wall:.3f}), {kernel} {own:.4f} s; top: "
        + "; ".join(f"{n[:60]} {t:.4f} s" for n, t in top))


def profile_phase(clips, Xs):
    """Where the time goes: the lifting and the enhancement forward, traced."""
    sub = clips[:16]  # the profiler's host cost is ~20x the traced work
    frames = sum(c.shape[0] for c in sub)
    for label, fn in (
        (f"lift {len(sub)} clips / {frames} frames",
         lambda: engine.lift_clips(sub, n_cycles=N_CYCLES, device="cuda")),
        (f"forward {len(Xs)} windows float32",
         lambda: infer.run_inference(
             registry.build_generator("v1", 36, 252, seed=SEED, device="cuda"),
             Xs, batch_size=128, num_samples=len(Xs), device="cuda")),
    ):
        log_trace(label, *profiled(fn), "filter_sgd")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run",
              file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    smi = nvidia_smi()
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)

    build_kernels(("filter_sgd", "robust_loss"))
    fp32 = filter_fp32_per_element_cycle()
    log(f"filter_sgd update: {fp32} FP32 instructions per element and cycle "
        "(SASS of the built library)")

    clips = synthetic_clips(np.random.RandomState(SEED), N_CLIPS)
    robust = robust_kernel_phase()
    prod, path = kernel_phase(clips, fp32)
    launches, r6d = path_phase(clips)
    robust_launches = train_phase(r6d)

    main_row = prod[-1]  # B=128, T=1920: the longest production bucket
    robust_row = robust[0]  # (128, 48384): the G step's residual
    kernels = [{
        "name": "filter_sgd",
        "route": "cuda",
        "source": "multimodal_hand_pose_enhancement_for_sign_language_tpu_torch/csrc/filter_sgd.cu",
        "replaces": "multimodal_hand_pose_enhancement_for_sign_language_tpu/ops/pallas_kernels.py:203",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in prod + path),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the filter
        "launch_plan": main_row["launch_plan"],
        # bound_ms over the elements this run's mask keeps
        "live_bound_ms": main_row["live_bound_ms"],
        "fp32_instructions_per_element_cycle": fp32,  # counted in the SASS
        "issue_floor_ms": main_row["issue_floor_ms"],
        "path_ms": sum(r["ms"] for r in path),  # the main path's batches, summed
    }, {
        "name": "robust_loss",
        "route": "cuda",
        "source": "multimodal_hand_pose_enhancement_for_sign_language_tpu_torch/csrc/robust_loss.cu",
        "replaces": "multimodal_hand_pose_enhancement_for_sign_language_tpu/ops/pallas_kernels.py:278",
        "launches": robust_launches,
        # the largest difference in loss or dx over the held shapes; the
        # values themselves reach 1e13 there (c down to 1e-3), and each is
        # held relative to its size (loss/dx_err_over_tol in the rows above)
        "max_abs_err": max(r["max_abs_err"] for r in robust),
        "max_err_over_tol": max(max(r["loss_err_over_tol"], r["dx_err_over_tol"])
                                for r in robust),
        "ms": robust_row["ms"],
        "plain_ms": robust_row["plain_ms"],
        "bound_ms": robust_row["bound_ms"],
        "bound_by": robust_row["bound_by"],
        "library_ms": None,  # no single PyTorch call computes rho and its dx
        "launch_plan": robust_row["launch_plan"],
    }]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
