#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from ``csrc/``, holds each against
its plain PyTorch version on the card (``filter_sgd`` at the production
shapes and on every batch the lifting path below launches, with that
batch's own inputs), then drives the serving chain once through the
port's entry points: synthetic 2D keypoint clips (lengths 64-1920, from a
seed) -> ``lift_clips`` (900 cycles, the ``filter_sgd`` kernel) -> xyz ->
aa -> r6d -> 192-frame windows -> the v1 ``arm2wh`` generator at full
width (36 -> 252, default_size 256, seeded weights) -> ``save_results``.
The lifting (shortest and longest clips), the generator's raw output and
the result xyz are checked against the port's CPU path.

Prints one line per phase, then a JSON line describing each kernel, the
card's name and power limit (``nvidia-smi``), and as the last line
``{"ok": true, "device": {...}}``.  Exits nonzero, with no result line,
on a machine without CUDA or when any phase fails.  Imports nothing of
JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch import infer
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data import (
    io,
    standardize,
    windows,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.lifting import engine
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models import registry
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops import (
    build,
    filter_sgd as fs,
    kinematics,
    rotations,
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


def hold_filter(ins, rows, label, reps=10):
    """filter_sgd's wrapper against its plain version on the card, on the
    first ``rows`` rows of ``ins`` (the rest are the all-masked padding of
    a pow2 batch, NaN in both); returns the measured row."""
    B, T = ins[-1].shape
    got = fs.filter_sgd(*ins, LR, N_CYCLES)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    want = fs.filter_sgd_plain(*ins, LR, N_CYCLES)
    t1.record()
    torch.cuda.synchronize()
    err = max(float((g[:rows] - w[:rows]).abs().max()) for g, w in zip(got, want))
    ms = cuda_ms(lambda: fs.filter_sgd(*ins, LR, N_CYCLES), reps=reps)
    elems = B * T * 50
    flop_s = fs.FLOPS_PER_ELEMENT_CYCLE * elems * N_CYCLES / PEAK_FP32_FLOPS
    byte_s = (fs.BYTES_PER_ELEMENT * elems + 4 * B * T) / PEAK_BYTES
    row = {
        "inputs": label, "B": B, "T": T, "n_cycles": N_CYCLES,
        "steps_per_thread": fs.steps_per_thread(B, T), "max_abs_err": err,
        "ms": ms, "plain_ms": t0.elapsed_time(t1), "bound_ms": 1e3 * max(flop_s, byte_s),
        "bound_by": "operations" if flop_s >= byte_s else "bytes",
    }
    log("kernel filter_sgd " + json.dumps(row))
    if not err <= FILTER_ATOL:
        raise AssertionError(f"filter_sgd disagrees with its plain version: {row}")
    return row


def kernel_phase(clips):
    """CUDA filter_sgd against its plain version at 900 cycles: at the
    production shapes B=128, T in {64, 256, 1920} (random planes, masked
    tails), then on every batch the lifting path launches for ``clips``,
    with that batch's own inputs (the engine's plan, packing and
    initialization).  Returns (production rows, path rows)."""
    rng = np.random.RandomState(SEED)
    prod = [hold_filter(filter_inputs(rng, 128, T, "cuda"), 128, "random")
            for T in (64, 256, 1920)]
    path = []
    for tb, chunk in engine._plan(clips):
        kps, masks, noises = (torch.from_numpy(a).to("cuda")
                              for a in engine._pack(chunk, tb))
        x0, y0, z0, Xx, Xy, Xw = engine._init_core(kps, masks, noises)
        path.append(hold_filter((x0, y0, z0, Xx, Xy, Xw, masks), len(chunk),
                                "path batch", reps=3))
    used = sorted({r["steps_per_thread"] for r in path})
    log(f"filter_sgd on the path's {len(path)} batches: steps_per_thread {used}, "
        f"max_abs_err {max(r['max_abs_err'] for r in path):.3e}, kernel "
        f"{sum(r['ms'] for r in path):.3f} ms summed, bound "
        f"{sum(r['bound_ms'] for r in path):.3f} ms, plain "
        f"{sum(r['plain_ms'] for r in path):.3f} ms")
    return prod, path


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


def path_phase(clips):
    """The serving chain on the card, checked against the CPU path; returns
    the filter_sgd launches of the main path."""
    frames = sum(c.shape[0] for c in clips)

    fs.filter_sgd.launches = 0  # counts of the main path start here
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
    r6d = rotations.aa_to_rot6d(aa, device="cuda")
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
        return _enhance_and_check(net, tmp, clips, xyz, X, Xs, sY, mY)


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


def profiled(fn):
    """Run ``fn`` under torch.profiler: (wall s, device-busy s, filter_sgd
    kernel s, top kernels by device time).  Device time is the sum of the
    CUDA kernel spans (one stream, so they do not overlap)."""
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
    busy = sum(by_name.values())
    filt = sum(v for k, v in by_name.items() if "filter_sgd" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return wall, busy, filt, top


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
        wall, busy, filt, top = profiled(fn)
        if busy <= 0:
            log(f"trace {label}: wall {wall:.3f} s; device time not measured "
                "(the profiler saw no CUDA kernels)")
            continue
        log(f"trace {label}: wall {wall:.3f} s, device busy {busy:.3f} s "
            f"(idle share {1 - busy / wall:.3f}), filter_sgd {filt:.3f} s; top: "
            + "; ".join(f"{n[:60]} {t:.4f} s" for n, t in top))


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

    t0 = time.perf_counter()
    build.load("filter_sgd")
    ptxas = [ln.strip() for ln in build.build_log.get("filter_sgd", {})
             .get("ptxas", "").splitlines() if "registers" in ln]
    log(f"build filter_sgd: {time.perf_counter() - t0:.2f} s; " + " | ".join(ptxas))

    clips = synthetic_clips(np.random.RandomState(SEED), N_CLIPS)
    prod, path = kernel_phase(clips)
    launches = path_phase(clips)

    main_row = prod[-1]  # B=128, T=1920: the longest production bucket
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
