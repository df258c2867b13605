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
bit for bit, one G and one D step on the card against the same step on
the CPU, and the checkpoint's strict reload.

Conditioned: the generators with text (v1, v2, v4, v4_deeper) and image
(b2h) conditioning, at full width, on seeded sentence embeddings and
per-frame image features written beside the r6d clips under the names the
CLIs read.  Each one's raw output on the card is held against the CPU at
float32 (TF32 must miss the bound) and timed at B=2048; v4 --require_text
and b2h --require_image train 2 epochs through ``train_gan.main`` (G and
val, then D; every regression loss through ``robust_loss``) and serve
from their checkpoints through ``inference.main``; one G and one D step of
v4_deeper and of b2h are held against the CPU as v1's are.

Raw data: the port's ``data/synthetic`` writes a seeded OpenPose JSON tree
of three splits (39,300 frames; grouped videos of 300 to 8,700 frames, four
longer than one filter block), and the port's ``process_dataset.main
--lift`` ingests it with the native scanner in spawn workers, groups the
utterances into videos and lifts them on the card (the long rows in
segments).  Checked: every frame went through the native scanner, the val
split's xy pickle against the JSON path, every filter batch of
the path against its plain version, the lifting of the two shortest and
two longest videos against the CPU path, finite r6d.

Classifier: the port's ``data/synthetic`` writes seeded r6d clips with
learnable categories and 384-wide sentence embeddings.  The LSTM topic
classifier at the root CLI's defaults (hidden 1024, 10 layers, B=128,
T=192) runs its eval forward unidirectional and bidirectional, held
against the CPU's float32 and float64 evaluations (TF32 must miss the
bound), and one Adam step (5 of the 10 layers) held as the GAN steps are;
``classifier_main.main`` trains 2 epochs twice with the same seeds
(identical losses, a strictly loading ``.pth``, the CSV) and
``classifier_mlp_main.main`` 2 epochs; train and val rates with one step
traced; a small LSTM and the MLP must clear the JAX package's learning
bars; remat at the grouped_r6d window (T=2112) must equal the plain run
to the bit with a lower peak memory.

Replay: the port's ``article_replay.main`` at ``--scale small`` (256 / 64 /
64 clips) and full width, with the signal fixtures, fingers 1-3, the
reference-config classifier for one epoch and the anomaly controls: the
fixture made on the card (held against the same fixture made on the CPU),
the raw smoke through ``process_dataset --lift`` at 60 cycles, both
canonical configs trained and served, the classifiers, the finger trend.
Checked: both kernels launched in the replay, the report complete (finite
L1 on every split, val steps run, accuracies in [0, 1]), ``filter_sgd`` on
every raw-smoke batch against its plain version, ``robust_loss`` held at
the replay's residual shapes; a ``{"replay": ...}`` line carries the stage
times and the table-shaped numbers.

Prints one line per phase, then a JSON line describing each kernel (with
its launch plan and, for the filter, the raw path's launches and long rows,
its bound over the live elements and
its FP32 issue floor from the instructions counted in the built
library's SASS), the card's name and power limit (``nvidia-smi``), and as
the last line ``{"ok": true, "device": {...}}``.  Exits nonzero, with no
result line, on a machine without CUDA or when any phase fails.  Imports
nothing of JAX.
"""

from __future__ import annotations

import copy
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch import (
    article_replay,
    classifier_main,
    classifier_mlp_main,
    infer,
    inference,
    process_dataset,
    train_gan,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data import (
    io,
    openpose,
    standardize,
    synthetic as synthetic,
    windows,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.lifting import engine
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.losses.robust import (
    AdaptiveLossFunction,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models import (
    classifier as clf_models,
    registry,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops import (
    build,
    filter_sgd as fs,
    kinematics,
    robust_loss as rl,
    rotations,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.runtime import native
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.train import (
    checkpoint as ckpt_lib,
    classifier as clf_train,
    data as data_lib,
    gan,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.constants import (
    ARMS,
    DATA_PATHS,
    HANDS,
    NECK,
    WINDOW_T,
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


def hold_filter(ins, rows, label, fp32, reps=10, n_cycles=N_CYCLES):
    """filter_sgd's wrapper against its plain version on the card, on the
    first ``rows`` rows of ``ins`` (the rest are the all-masked padding of
    a pow2 batch, which the plain version makes NaN); the masked tails of
    those rows must come out as x0 exactly.  ``fp32``: FP32 instructions
    per element and cycle, for the issue floor.  Returns the measured row."""
    B, T = ins[-1].shape
    before = fs.filter_sgd.launches
    got = fs.filter_sgd(*ins, LR, n_cycles)
    launches = fs.filter_sgd.launches - before
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    want = fs.filter_sgd_plain(*ins, LR, n_cycles)
    t1.record()
    torch.cuda.synchronize()
    err = max(float((g[:rows] - w[:rows]).abs().max()) for g, w in zip(got, want))
    masked = (ins[-1][:rows] == 0)[:, :, None].expand(-1, -1, 50)
    tails_exact = all(torch.equal(g[:rows][masked], x[:rows][masked])
                      for g, x in zip(got, ins[:3]))
    ms = cuda_ms(lambda: fs.filter_sgd(*ins, LR, n_cycles), reps=reps)
    elems = B * T * 50
    live = int(ins[-1].sum()) * 50  # the mask sum x 50 joints
    byte_s = (fs.BYTES_PER_ELEMENT * elems + 4 * B * T) / PEAK_BYTES
    flop_s = fs.FLOPS_PER_ELEMENT_CYCLE * elems * n_cycles / PEAK_FP32_FLOPS
    live_flop_s = fs.FLOPS_PER_ELEMENT_CYCLE * live * n_cycles / PEAK_FP32_FLOPS
    instr = fp32 * n_cycles / PEAK_FP32_INSTR
    row = {
        "inputs": label, "B": B, "T": T, "n_cycles": n_cycles,
        "launch_plan": dict(zip("KLWRGH", fs.launch_plan(B, T))), "launches": launches,
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


# The raw phase's OpenPose tree: per split, the utterances of each video
# (RAW_UTT_FRAMES frames each; How2Sign's utterances average ~290 frames),
# 39,300 frames in all.  The grouped videos run from 300 to 8,700 frames:
# four are longer than one filter block (4,320 steps), and the 8,700-frame
# one spans three segments.  Cut from a How2Sign split (~10M frames).
RAW_VIDEOS = {"train": [29, 17, 12, 5, 2, 1], "val": [15, 9, 3, 1], "test": [22, 9, 4, 2]}
RAW_UTT_FRAMES = 300
NATIVE_RTOL = 1e-6  # the native scanner's float32 parse (tests/test_native_runtime.py)
# the split whose xy the JSON path reads again (8,400 frames; all three
# splits took 17.5-23.7 s, cut to keep the script's time with the replay phase)
RAW_JSON_SPLIT = "val"


def raw_xy_json(root, split):
    """The split's xy clips through the port's ingestion with the native
    scanner off: the JSON path, in this process (threads overlap the file
    reads)."""
    json_dir = os.path.join(root, DATA_PATHS[split])
    ids = sorted(os.listdir(json_dir))
    with ThreadPoolExecutor(max_workers=8) as ex:
        kps = list(ex.map(lambda u: openpose.load_utterance(
            os.path.join(json_dir, u), use_native=False), ids))
    _, ins, outs = openpose.group_clips(ids, [k[0] for k in kps], [k[1] for k in kps])
    return openpose.hconcat_feats(openpose.select_keypoints(ins, NECK),
                                  openpose.select_keypoints(ins, ARMS),
                                  openpose.select_keypoints(outs, HANDS))


def parse_rates(root, n=3000):
    """Frames/s of the native scanner and of the JSON path on ``n`` frames
    already in memory (parsing alone, one process)."""
    json_dir = os.path.join(root, DATA_PATHS["train"])
    files = sorted(os.path.join(json_dir, u, f) for u in os.listdir(json_dir)
                   for f in os.listdir(os.path.join(json_dir, u)))[:n]
    bufs = [open(f, "rb").read() for f in files]
    t0 = time.perf_counter()
    for b in bufs:
        native.parse_openpose_frame_bytes(b)
    t1 = time.perf_counter()
    for b in bufs:
        openpose.parse_frame_json(json.loads(b))
    return len(bufs) / (t1 - t0), len(bufs) / (time.perf_counter() - t1)


def raw_batches(feats, n_partitions):
    """The filter batches ``lift_2d_to_3d`` launches for ``feats``: its
    partitions, each planned and packed as ``lift_clips`` does."""
    idx = len(feats) // n_partitions + 1
    for i in range(n_partitions):
        chunk = feats[idx * i : idx * (i + 1)]
        if chunk:
            yield from engine._plan(chunk)


def raw_phase(fp32):
    """The raw-data entry on the card: a seeded OpenPose tree of three splits
    (``RAW_VIDEOS``) through the port's ``process_dataset.main --lift`` at
    900 cycles, counts at 0 just before.  Checked: every frame went through
    the native scanner; the val xy pickle against the JSON path (rtol 1e-6);
    every filter
    batch of the path against its plain version (the long rows too); the
    lifting of the two shortest and two longest videos against the port's
    CPU path; finite (T, 288) r6d.  Returns (filter_sgd launches of the
    path, the held batches)."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_raw_") as tmp:
        root, data_dir = os.path.join(tmp, "raw"), os.path.join(tmp, "data")
        t0 = time.perf_counter()
        for i, split in enumerate(RAW_VIDEOS):
            synthetic.make_openpose_tree(root, frames=RAW_UTT_FRAMES, seed=SEED + i,
                                            videos=RAW_VIDEOS[split], splits=(split,))
        n_frames = RAW_UTT_FRAMES * sum(map(sum, RAW_VIDEOS.values()))
        log(f"raw tree: {n_frames} frames in "
            f"{sum(map(len, RAW_VIDEOS.values()))} videos written in "
            f"{time.perf_counter() - t0:.1f} s")
        workers = len(os.sched_getaffinity(0))
        args = process_dataset.resolve_templates(process_dataset.build_parser().parse_args(
            ["--dataset_path", root, "--data_dir", data_dir, "--lift", "--device", "cuda",
             "--n_cycles", str(N_CYCLES), "--workers", str(workers)]))

        fs.filter_sgd.launches = 0  # counts of the raw path start here
        openpose.FRAMES.update(native=0, json=0)
        t0 = time.perf_counter()
        stats = process_dataset.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, parsed = fs.filter_sgd.launches, dict(openpose.FRAMES)

        ingest = sum(s["ingest_s"] for s in stats.values())
        lift_s = sum(s["lift_s"] for s in stats.values())
        log(f"raw process_dataset: {wall:.1f} s, {workers} ingestion workers; "
            + "; ".join(f"{k} {s['utterances']} utterances -> {s['clips']} videos, "
                        f"{s['frames']} frames, ingest {s['ingest_s']:.2f} s, lift + r6d "
                        f"{s['lift_s']:.2f} s" for k, s in stats.items())
            + f"; native scanner {parsed['native']} frames, json {parsed['json']}; "
            f"ingest {n_frames / ingest:.0f} frames/s, lift + r6d {n_frames / lift_s:.0f} "
            f"frames/s; filter_sgd launches {launches}")
        if parsed != {"native": n_frames, "json": 0}:
            raise AssertionError(f"not every frame went through the native scanner: {parsed}")

        t0 = time.perf_counter()
        feats, xyz = {}, {}
        for split in RAW_VIDEOS:
            feats[split] = io.load_binary(os.path.join(data_dir, f"xy_{split}.pkl"))
            json_xy = raw_xy_json(root, split) if split == RAW_JSON_SPLIT else feats[split]
            if len(json_xy) != len(feats[split]) or not all(
                    np.allclose(a, b, rtol=NATIVE_RTOL, atol=0)
                    for a, b in zip(feats[split], json_xy)):
                raise AssertionError(f"{split}: native xy differs from the JSON path")
            xyz[split] = io.load_binary(os.path.join(data_dir, f"xyz_{split}.pkl"))
            r6d = io.load_binary(os.path.join(data_dir, f"r6d_{split}.pkl"))
            if not all(r.shape == (c.shape[0], 288) and np.isfinite(r).all()
                       for r, c in zip(r6d, feats[split])):
                raise AssertionError(f"{split}: r6d is not finite (T, 288) per video")
        json_s = time.perf_counter() - t0
        native_rate, json_rate = parse_rates(root)
        json_frames = RAW_UTT_FRAMES * sum(RAW_VIDEOS[RAW_JSON_SPLIT])
        log(f"raw xy: native within rtol {NATIVE_RTOL} of the JSON path ({RAW_JSON_SPLIT}: "
            f"{json_frames} frames read and parsed again in one process in {json_s:.1f} s), "
            f"r6d finite (T, 288); "
            f"parsing alone, one process: native {native_rate:.0f} frames/s, JSON "
            f"{json_rate:.0f} frames/s")

        held = []
        for split in RAW_VIDEOS:
            for tb, chunk in raw_batches(feats[split], args.n_partitions):
                kps, masks, noises = (torch.from_numpy(a).to("cuda")
                                      for a in engine._pack(chunk, tb))
                held.append(hold_filter(engine._init_core(kps, masks, noises) + (masks,),
                                        len(chunk), "raw batch", fp32, reps=3))
        for r in held:
            if len(r["launch_plan"]) == 6:
                log(f"raw long row B={r['B']} T={r['T']}: plan {r['launch_plan']}, "
                    f"{r['launches']} launches, {r['ms']:.3f} ms, bound {r['bound_ms']:.3f} "
                    f"ms ({r['bound_by']}), live bound {r['live_bound_ms']:.3f} ms, plain "
                    f"{r['plain_ms']:.3f} ms, max_abs_err {r['max_abs_err']:.3e}")
        log(f"filter_sgd on the raw path's {len(held)} batches: T up to "
            f"{max(r['T'] for r in held)}, max_abs_err "
            f"{max(r['max_abs_err'] for r in held):.3e}, kernel "
            f"{sum(r['ms'] for r in held):.3f} ms summed, bound "
            f"{sum(r['bound_ms'] for r in held):.3f} ms, plain "
            f"{sum(r['plain_ms'] for r in held):.3f} ms")

        clips = [(c.shape[0], split, i) for split in RAW_VIDEOS
                 for i, c in enumerate(feats[split])]
        picked = [key for key in sorted(clips)[:2] + sorted(clips)[-2:]]
        t0 = time.perf_counter()
        cpu = engine.lift_clips([feats[s][i] for _, s, i in picked], n_cycles=N_CYCLES,
                                device="cpu")
        xy_err, z_err, err = lift_close([xyz[s][i] for _, s, i in picked], cpu)
        log(f"raw lifting card vs CPU, videos of {[t for t, _, _ in picked]} frames: "
            f"max |dx|,|dy| {xy_err:.3e}, max |dz| {z_err:.3e}, MPJPE {err:.3e} "
            f"({time.perf_counter() - t0:.1f} s)")
        if not (xy_err <= LIFT_ATOL and err <= LIFT_ATOL and z_err <= LIFT_Z_ATOL):
            raise AssertionError("raw lifting on the card disagrees with the CPU path")
    return launches, held


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


_RETRIED_HOLDS = 0  # robust holds in a row that needed more than one profiler session


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
    # a session of torch.profiler on this card now and then reports no CUDA
    # kernel at all (H100, torch 2.11): up to three sessions, and a second
    # hold in a row that needs more than one fails the run
    global _RETRIED_HOLDS
    for sessions in range(1, 4):
        _, by_name, _ = profiled(lambda: [rl.robust_loss_and_dx(x, alpha, c)
                                          for _ in range(reps)])
        spans = [v for k, v in by_name.items() if "robust_loss_kernel" in k]
        if spans:
            break
    else:
        raise AssertionError("in three profiler sessions none saw a robust_loss_kernel "
                             f"span: {sorted(by_name)}")
    _RETRIED_HOLDS = _RETRIED_HOLDS + 1 if sessions > 1 else 0
    if _RETRIED_HOLDS > 1:
        raise AssertionError(f"two robust_loss holds in a row needed more than one profiler "
                             f"session (this one {sessions}) at {(N, D)}")
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
        "ms": ms, "profiler_sessions": sessions, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
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
    the filter_sgd launches of the main path and the xyz and r6d clips it
    made."""
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
        return _enhance_and_check(net, tmp, clips, xyz, X, Xs, sY, mY), xyz, r6d


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
# One step on the card against the same step on the CPU, dropout 0: the
# trainer's own step, which runs PyTorch's own CUDA convolutions (cuDNN
# off, train/gan.py).  The loss is held relative, the running statistics
# absolute (the CPU tests' 5e-6, tests/test_torch_gan.py).  The generator's
# gradients are ill-conditioned at float32 (train-mode BatchNorm backward
# over channels of tiny variance): on these clips the CPU's float32
# gradient is about 1% of the largest entry away from a float64 evaluation
# of the same step.  So the card's gradients are held against that float64
# evaluation: they may be STEP_GRAD_FACTOR times as far from it as the
# CPU's float32 ones, no further, and in no tensor STEP_TENSOR_FACTOR times
# as far (two float32 evaluations that sum in different orders: on these
# steps the card's error reaches 7.0 times the CPU's in one tensor, where
# cuDNN's convolutions reach 11491, chip_step_precision.py).  Those two
# bounds hold rounding, so each float32 step is measured against a float64
# step that takes the same branch at every LeakyReLU, ReLU and max pool
# (``Branches``): where a pre-activation lies within rounding of a kink, a
# float32 step may take the other branch than float64 and route that
# entry's gradient with slope 0.2 instead of 1, an error of up to the whole
# upstream gradient there, which lands in whichever evaluation happened to
# flip (v1's G step: 14.5 times the CPU's error in skip5.1's bias against
# the plain float64 step, 1.6 at most in any tensor on matched branches,
# once more accurate lifting changed the batch).  The flips of each
# evaluation, and the measures against the plain float64 step, are
# reported beside them.
# Adam's first update is lr * g / (|g| + eps), a sign: an entry whose
# float64 gradient is within STEP_NOISE_FACTOR of the CPU's float32 error in
# its tensor is noise at float32 and is masked, as the CPU tests mask
# 0 < |g| < 1e-6 at their loss of order 1.  In a tensor where the card's
# error is larger than that, the mask reaches up to the card's error and no
# further: outside it neither evaluation can have flipped a sign.  (b2h's
# G step: in encoder.1.weight the CPU's error is 2.99e-5 and the card's
# 1.47e-4, and one entry beyond 4 times the CPU's error flipped,
# chip_step_precision.py.)  The
# mask may cover no more than STEP_MASKED_SHARE of the entries, and the
# share masked by the CPU's error alone is reported beside it.  Outside the
# mask the card's and the CPU's parameters must agree to STEP_ATOL; inside
# it they may differ by the 2 * lr a flipped sign moves them, and no more.
# The entries whose sign differs from the float64 step's are counted for
# the card and for the CPU and reported.
STEP_LOSS_RTOL = 1e-5
STEP_ATOL = 5e-6
STEP_GRAD_FACTOR = 2.0
STEP_TENSOR_FACTOR = 8.0
STEP_NOISE_FACTOR = 4.0
STEP_MASKED_SHARE = 0.25
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


def _cond_kwargs(cond):
    """GanConfig / build_generator flags of a conditioning: None, "text" or
    "image"."""
    return {"require_text": cond == "text", "require_image": cond == "image"}


class Branches(TorchFunctionMode):
    """Records the branch that every LeakyReLU, ReLU and max pool of a step
    takes (``taken``: each call's positive mask or argmax, in call order),
    or, given such a record, replays it: the op computes its value on the
    recorded branch, so its gradient follows that branch, and ``flips``
    counts the entries where the record differs from this evaluation's own
    choice."""

    def __init__(self, replay=None):
        super().__init__()
        self.taken = []
        self.replay = None if replay is None else iter(replay)
        self.flips = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name in ("relu", "leaky_relu") and not kwargs.get("inplace"):
            x = args[0]
            own = x > 0
            if self.replay is None:
                self.taken.append(own.cpu())
                return func(*args, **kwargs)
            pos = next(self.replay).to(x.device)
            self.flips += int((pos != own).sum())
            slope = 0.0 if name == "relu" else kwargs.get(
                "negative_slope", args[1] if len(args) > 1 else 0.01)
            return torch.where(pos, x, x * slope)
        if name == "max_pool1d" and not kwargs.get("return_indices"):
            x = args[0]
            out, own = func(*args, **{**kwargs, "return_indices": True})
            if self.replay is None:
                self.taken.append(own.cpu())
                return out
            idx = next(self.replay).to(x.device)
            self.flips += int((idx != own).sum())
            return torch.gather(x, -1, idx)
        return func(*args, **kwargs)


def _one_step(kind, x, y, device, dtype=torch.float32, model="v1", cond=None,
              feats=None, replay=None):
    """(loss, module stepped, its gradients, Branches) after one ``kind``
    step of the trainer from the seeded weights, dropout 0, its branches
    recorded (or, with ``replay``, taken from that record).  A parameter the
    loss does not reach (the dead branch of v4_deeper) has no gradient and
    is left out of them."""
    cfg = gan.GanConfig(model=model, loss="RobustLoss", disc_label_smooth=True,
                        batch_size=x.shape[0], dropout_rate=0.0, **_cond_kwargs(cond))
    tr = gan.GanTrainer(cfg, device=device)
    for m in (tr.generator, tr.discriminator, tr.adaptive):
        m.to(dtype)
    before = rl.robust_lossfun.launches
    assert tr.cfg.learning_rate == STEP_LR
    with Branches(replay) as branches:
        loss = float(tr._step(kind)(*(
            None if a is None else torch.from_numpy(a).to(device=device, dtype=dtype)
            for a in (x, y, feats))))
    if device == "cuda" and rl.robust_lossfun.launches != before + (kind == "g"):
        raise AssertionError(f"the card's {kind} step did not go through the kernel")
    module = tr.generator if kind == "g" else tr.discriminator
    grads = {k: p.grad.double().cpu() for k, p in module.named_parameters()
             if p.grad is not None}
    return loss, {k: v.cpu() for k, v in module.state_dict().items()}, grads, branches


def step_against_cpu(kind, x, y, model="v1", cond=None, feats=None):
    """One ``kind`` step ('g' or 'd') of ``model`` on the card, on the CPU,
    and on the CPU in float64 (once on its own branches, once on each
    float32 step's), from the same seeded weights and batch, held by
    ``hold_step``."""
    cfg = dict(model=model, cond=cond, feats=feats)
    card = _one_step(kind, x, y, "cuda", **cfg)
    cpu = _one_step(kind, x, y, "cpu", **cfg)
    same = [_one_step(kind, x, y, "cpu", torch.float64, replay=run[3].taken, **cfg)
            for run in (card, cpu)]
    return hold_step({"model": model, "conditioning": cond, "step": kind}, card, cpu,
                     _one_step(kind, x, y, "cpu", torch.float64, **cfg), STEP_LR, same)


def hold_step(head, card, cpu, ref, lr, same=None):
    """Hold one step on the card against the same step on the CPU and on the
    CPU in float64: each a (loss, state_dict after the step, gradients, ...)
    from the same weights and batch; ``same``, if given, holds the float64
    steps on the card's and on the CPU's branches (``Branches``), against
    which the gradient bounds hold the rounding of each.  Fails beyond the
    STEP_* tolerances, with ``lr`` the step's learning rate; returns what
    came out (``head`` first).  The running statistics, and the parameters
    the loss does not reach (they must not move), are held at STEP_ATOL."""
    loss_card, sd_card, g_card = card[:3]
    loss_cpu, sd_cpu, g_cpu = cpu[:3]
    g_ref = ref[2]
    g_same_card, g_same_cpu = (g_ref, g_ref) if same is None else (r[2] for r in same)
    worst = worst_masked = worst_stat = err_card = err_cpu = grad_max = ratio = 0.0
    round_card = round_cpu = round_ratio = 0.0
    masked = masked_cpu = masked_fixed = total = flips_card = flips_cpu = 0
    ratio_at = worst_at = round_at = None
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
        if e_card / max(e_cpu, 1e-30) > ratio:
            ratio, ratio_at = e_card / max(e_cpu, 1e-30), k
        r_card = float((g_card[k] - g_same_card[k]).abs().max())
        r_cpu = float((g_cpu[k] - g_same_cpu[k]).abs().max())
        round_card, round_cpu = max(round_card, r_card), max(round_cpu, r_cpu)
        if r_card / max(r_cpu, 1e-30) > round_ratio:
            round_ratio, round_at = r_card / max(r_cpu, 1e-30), k
        g = g_ref[k].abs()
        grad_max = max(grad_max, float(g.max()))
        keep = g >= max(STEP_NOISE_FACTOR * e_cpu, e_card)
        total += keep.numel()
        masked += int((~keep).sum())
        masked_cpu += int((g < STEP_NOISE_FACTOR * e_cpu).sum())
        masked_fixed += int(((g > 0) & (g < 1e-6)).sum())  # the CPU tests' mask
        flips_card += int((torch.sign(g_card[k]) != torch.sign(g_ref[k])).sum())
        flips_cpu += int((torch.sign(g_cpu[k]) != torch.sign(g_ref[k])).sum())
        if float((diff * keep).max()) > worst:
            worst, worst_at = float((diff * keep).max()), k
        worst_masked = max(worst_masked, float((diff * ~keep).max()))
    row = {
        **head,
        "loss_card": loss_card, "loss_cpu": loss_cpu,
        "loss_rel_err": abs(loss_card - loss_cpu) / max(abs(loss_cpu), 1e-30),
        "running_stat_err": worst_stat, "grad_abs_max": grad_max,
        "grad_err_card_vs_float64": err_card, "grad_err_cpu_vs_float64": err_cpu,
        "largest_tensor_grad_err_card_over_cpu": ratio, "at": ratio_at,
        "same_branches": same is not None,
        "grad_err_card_vs_float64_same_branches": round_card,
        "grad_err_cpu_vs_float64_same_branches": round_cpu,
        "largest_tensor_ratio_same_branches": round_ratio, "same_branches_at": round_at,
        "branch_flips_card": None if same is None else same[0][3].flips,
        "branch_flips_cpu": None if same is None else same[1][3].flips,
        "param_err_outside_mask": worst, "param_err_outside_mask_at": worst_at,
        "param_err_inside_mask": worst_masked,
        "masked_share": masked / total, "masked_share_by_cpu_error": masked_cpu / total,
        "masked_share_of_1e-6_mask": masked_fixed / total,
        "signs_off_float64_card": flips_card, "signs_off_float64_cpu": flips_cpu,
    }
    log("step card vs cpu " + json.dumps(row))
    if not (row["loss_rel_err"] <= STEP_LOSS_RTOL and worst_stat <= STEP_ATOL
            and worst <= STEP_ATOL and worst_masked <= 2 * lr + STEP_ATOL
            and round_card <= STEP_GRAD_FACTOR * round_cpu
            and round_ratio <= STEP_TENSOR_FACTOR
            and row["masked_share"] <= STEP_MASKED_SHARE):
        raise AssertionError(f"the card's step {head} disagrees with the CPU's: {row}")
    return row


def timed_epochs(trainer, X, Y, kind, batch_size, resident, repeats=5,
                 feats=None, label="v1"):
    """Steps/s and frames/s of ``repeats`` epochs of one kind after one
    warm-up epoch; the host clock around work that ends in a synchronise."""
    sX, sY, sF = trainer.stage(X, Y, feats) if resident else (None, None, None)
    order = np.arange(len(X))

    def epoch():
        if resident:
            return trainer.run_epoch_resident(sX, sY, order, kind, batch_size, sF)
        return trainer.run_epoch(X, Y, kind, batch_size, feats)

    epoch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(repeats):
        epoch()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    steps = repeats * (len(X) // batch_size)
    log(f"train rate {label} {kind} epoch "
        f"({'resident' if resident else 'host batches'}, B={batch_size}): "
        f"{steps} steps in {dt:.3f} s = {steps / dt:.2f} steps/s, "
        f"{steps * batch_size * X.shape[1] / dt:.1f} frames/s")


def epoch_watch(cfg):
    """(hook, seen) for ``train_gan.main``: the hook fails an epoch whose
    losses are not finite, that moved another module than its kind's, or
    that moved the robust latents; ``seen`` collects (epoch, kind, losses).
    The weights are a function of the seed, so a trainer built from ``cfg``
    holds the state before epoch 0."""
    first = gan.GanTrainer(cfg, device="cuda")
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

    return hook, seen


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
        hook, seen = epoch_watch(gan.GanConfig(loss="RobustLoss"))
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
    staged = trainer.stage(X, Y)
    log_trace(f"one G epoch, {len(X) // TRAIN_BATCH} steps of B={TRAIN_BATCH} (resident)",
              *profiled(lambda: trainer.run_epoch_resident(
                  *staged, np.arange(len(X)), "g", TRAIN_BATCH)), "robust_loss")
    return launches

# conditioned phase: each generator with the conditioning it has
COND_FORWARD = (("v1", "text"), ("v2", "text"), ("v4", "text"),
                ("v4_deeper", "text"), ("b2h", "image"))
COND_TRAINED = (("v4", "text"), ("b2h", "image"))
COND_STEPPED = (("v4_deeper", "text"), ("b2h", "image"))
COND_TRAIN_CLIPS, COND_VAL_CLIPS = 256, 128
COND_EPOCHS = 2  # with --epochs_train_disc 1: epoch 0 trains G and validates, 1 D
N_COND_CPU_WINDOWS = 64
FWD_BATCH = 2048


def write_conditioned_data(data_dir, xyz, r6d, rng):
    """The conditioned phase's splits under the names the CLIs read: train
    the first COND_TRAIN_CLIPS clips, val the last COND_VAL_CLIPS.  Each
    clip is cut to its first 192 frames, the window the loaders keep (so
    the windows are those of the whole clips, and the per-frame image
    features stay under 0.6 GB); xyz_train gives save_results its root and
    bone lengths; seeded text embeddings (n_clips, 512), normal and
    average; seeded image features (T_clip, 2000) per clip."""
    n = len(r6d)
    splits = {"train": range(COND_TRAIN_CLIPS), "val": range(n - COND_VAL_CLIPS, n)}
    io.save_binary([xyz[i][:WINDOW_T] for i in splits["train"]],
                   os.path.join(data_dir, "xyz_train"))
    for split, idx in splits.items():
        clips = [r6d[i][:WINDOW_T] for i in idx]
        io.save_binary(clips, os.path.join(data_dir, f"r6d_{split}"))
        for prefix in ("", "average_"):
            io.save_binary(rng.standard_normal((len(clips), 512), dtype=np.float32),
                           os.path.join(data_dir, f"{prefix}{split}_sentence_embeddings"))
        io.save_binary([rng.standard_normal((c.shape[0], 2000), dtype=np.float32)
                        for c in clips], os.path.join(data_dir, f"{split}_vid_feats"))


def cond_forward(model, cond, X, F):
    """A conditioned generator with seeded weights: its raw output on the
    card against the CPU's on the first N_COND_CPU_WINDOWS windows, held at
    2^-15 of the largest output at float32 (TF32 must miss that bound), and
    its forward ms at B=2048, T=192 (the windows and features tiled on the
    card: 3.1 GB of image features for b2h)."""
    kw = _cond_kwargs(cond)
    net = registry.build_generator(model, 36, 252, seed=SEED, device="cuda", **kw)
    n = N_COND_CPU_WINDOWS
    cpu = registry.build_generator(model, 36, 252, seed=SEED, device="cpu", **kw)
    want, _ = infer.run_inference(cpu, X[:n], test_feats=F[:n], batch_size=n,
                                  num_samples=n, device="cpu")
    err = {}
    for precision in ("float32", "tensorfloat32"):
        got, _ = infer.run_inference(net, X[:n], test_feats=F[:n], batch_size=n,
                                     num_samples=n, matmul_precision=precision,
                                     device="cuda")
        if got.shape != (n, WINDOW_T, 252) or not np.isfinite(got).all():
            raise AssertionError(f"{model}: bad output {got.shape}")
        err[precision] = float(np.abs(got - want).max())
    atol = FWD_REL_ATOL * float(np.abs(want).max())

    idx = torch.arange(FWD_BATCH, device="cuda") % len(X)
    xb = torch.from_numpy(X).to("cuda")[idx].transpose(1, 2)
    fb = torch.from_numpy(F).to("cuda")[idx]
    ms = {}
    with torch.no_grad():
        for precision in ("float32", "tensorfloat32"):
            with infer.conv_matmul_precision(precision):
                ms[precision] = cuda_ms(lambda: net(xb, fb), reps=5)
    del xb, fb
    row = {"model": model, "conditioning": cond,
           "params": sum(p.numel() for p in net.parameters()),
           "raw_err_float32": err["float32"],
           "raw_err_tensorfloat32": err["tensorfloat32"], "atol": atol,
           "forward_ms_float32": ms["float32"],
           "forward_ms_tensorfloat32": ms["tensorfloat32"],
           "frames_per_s_float32": FWD_BATCH * WINDOW_T / ms["float32"] * 1e3}
    log("conditioned forward " + json.dumps(row))
    if not err["float32"] <= atol:
        raise AssertionError(f"{model}: float32 forward on the card off by {err['float32']}")
    if not err["tensorfloat32"] > atol:
        raise AssertionError(f"{model}: the raw-output check cannot tell TF32 from float32")
    return row


def cond_train(model, cond, tmp, data_dir, data):
    """``train_gan.main`` for ``model`` with its conditioning: COND_EPOCHS
    epochs at B=128 under RobustLoss, each epoch watched; then
    ``inference.main`` from its checkpoint and the G, D and val rates.
    Returns the robust-loss launches of the training run."""
    exp = f"cond_{model}"
    args = train_gan.build_parser().parse_args([
        "--base_path", tmp, "--data_dir", data_dir,
        "--model_path", os.path.join(tmp, "models"), "--exp_name", exp,
        "--model", model, f"--require_{cond}",
        "--num_epochs", str(COND_EPOCHS), "--epochs_train_disc", "1",
        "--batch_size", str(TRAIN_BATCH), "--loss", "RobustLoss",
        "--disc_label_smooth", "--device", "cuda",
    ])
    cfg = gan.GanConfig(model=model, loss="RobustLoss", disc_label_smooth=True,
                        **_cond_kwargs(cond))
    hook, seen = epoch_watch(cfg)
    rl.robust_lossfun.launches = 0  # counts of this training path start here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best = train_gan.main(args, epoch_hook=hook)
    torch.cuda.synchronize()
    launches = rl.robust_lossfun.launches  # end of this training path
    log(f"train_gan.main {model} --require_{cond}: {COND_EPOCHS} epochs in "
        f"{time.perf_counter() - t0:.3f} s, best val {best:.6f}, robust_loss launches "
        f"{launches}; " + "; ".join(f"epoch {e} {k} {json.dumps(l)}" for e, k, l in seen))
    if [k for _, k, _ in seen] != ["g", "d"]:
        raise AssertionError(f"{model}: unexpected schedule {seen}")
    steps = len(data["train_X"]) // TRAIN_BATCH + len(data["val_X"]) // (TRAIN_BATCH // 2)
    if launches != steps or launches <= 0:
        raise AssertionError(f"{model}: robust_loss launched {launches} times for "
                             f"{steps} G and val batches")

    iargs = inference.build_parser().parse_args([
        "--checkpoint", os.path.join(args.model_path, f"lastCheckpoint_{exp}.pth"),
        "--base_path", tmp, "--data_dir", data_dir, "--infer_set", "val",
        "--exp_name", exp, "--model", model, f"--require_{cond}",
        "--batch_size", str(TRAIN_BATCH), "--device", "cuda",
    ])
    cwd = os.getcwd()
    os.chdir(tmp)  # save_results writes root.pkl / bone_len.pkl to the cwd
    try:
        err = inference.main(iargs)
    finally:
        os.chdir(cwd)
    xyz = np.asarray(io.load_binary(os.path.join(tmp, f"results_{exp}", "xyz_val.pkl")))
    log(f"inference.main from the {model} checkpoint: xyz {xyz.shape}, L1 {err:.6f}")
    if (xyz.shape != (len(data["val_X"]), WINDOW_T, 150) or not np.isfinite(xyz).all()
            or not np.isfinite(err)):
        raise AssertionError(f"{model}: bad inference from the trained checkpoint")

    trainer = gan.GanTrainer(cfg, device="cuda")
    # an epoch here is 2 steps: G 3 epochs (~0.5 s), D and val 30 (~0.3 s)
    for kind, bs, part, reps in (("g", TRAIN_BATCH, "train", 3),
                                 ("d", TRAIN_BATCH, "train", 30),
                                 ("val", TRAIN_BATCH // 2, "val", 30)):
        timed_epochs(trainer, data[f"{part}_X"], data[f"{part}_Y"], kind, bs, True,
                     repeats=reps, feats=data[f"{part}_feats"], label=f"{model}+{cond}")
    sX, sY, sF = trainer.stage(data["train_X"], data["train_Y"], data["train_feats"])
    log_trace(f"one {model}+{cond} G epoch, {len(data['train_X']) // TRAIN_BATCH} "
              f"steps of B={TRAIN_BATCH} (resident)",
              *profiled(lambda: trainer.run_epoch_resident(
                  sX, sY, np.arange(len(data["train_X"])), "g", TRAIN_BATCH, sF)),
              "robust_loss")
    return launches


def conditioned_phase(xyz, r6d):
    """Every generator with its conditioning, at full width, on the card;
    returns the robust-loss launches of the conditioned trainings."""
    launches = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cond_") as tmp:
        data_dir = os.path.join(tmp, "data")
        os.makedirs(data_dir)
        write_conditioned_data(data_dir, xyz, r6d, np.random.default_rng(SEED + 2))
        for cond in ("text", "image"):
            data = data_lib.load_data(
                data_dir, "arm2wh", os.path.join(tmp, "stats"), "cond",
                np.random.RandomState(23456), base_path=tmp, **_cond_kwargs(cond))
            X, Y, F = data["train_X"], data["train_Y"], data["train_feats"]
            for model in (m for m, c in COND_FORWARD if c == cond):
                cond_forward(model, cond, X, F)
            for model in (m for m, c in COND_TRAINED if c == cond):
                launches += cond_train(model, cond, tmp, data_dir, data)
            for model in (m for m, c in COND_STEPPED if c == cond):
                for kind in ("g", "d"):
                    step_against_cpu(kind, X[:TRAIN_BATCH], Y[:TRAIN_BATCH], model,
                                     cond, F[:TRAIN_BATCH])
            del data, X, Y, F
    return launches


# classifier phase: the LSTM topic classifier at the root CLI's defaults
# (hidden 1024, 10 layers, unidirectional, B=128, T=192; the reference's
# main.py:143-160) on the r6d width of seeded clips, and the sentence MLP
CLS_HIDDEN, CLS_LAYERS = 1024, 10
CLS_BATCH = 128
CLS_TRAIN_CLIPS = 512  # 4 train steps an epoch at B=128; val 256 clips, 2 steps
CLS_EPOCHS = 2
CLS_CPU_ROWS = 16  # rows of the card's B=128 forward also evaluated on the CPU
CLS_STEP_BATCH = 4  # the step check's batch (at full width)
# the step check's depth: 5 of the 10 layers (the CPU's float64 step of all
# ten took 26-44 s, cut to keep the script's time with the replay phase)
CLS_STEP_LAYERS = 5
# the card's float32 logits may be CLS_FWD_FACTOR times as far from a
# float64 evaluation as the CPU's float32 ones, and no further; TF32 must
# land beyond that
CLS_FWD_FACTOR = 2.0
CLS_LR, CLS_WD = 1e-4, 1e-3  # classifier_main's defaults
CLS_GROUPED_T = 2112  # --data_type grouped_r6d's window (train/classifier.load_data)
CLS_REMAT_BATCH = 8
# the JAX package's learning bars (tests/test_classifier.py:195, :226)
CLS_LSTM_BAR, CLS_MLP_BAR = 0.4, 0.5


def lstm_flops(B, T, D, H, L, dirs, classes=10):
    """2 x the multiply-adds of one ClassifLSTM forward: every layer's and
    direction's input and recurrent products, and the head."""
    f = sum(dirs * 2 * B * T * 4 * H * ((D if k == 0 else dirs * H) + H) for k in range(L))
    return f + 2 * B * T * dirs * H * classes


def _lstm_kwargs(D, bidir, **over):
    return {"input_size": D, "hidden_size": CLS_HIDDEN, "num_layers": CLS_LAYERS,
            "bidirectional": bidir, **over}


def cls_forward(X):
    """Eval logits of the full-width LSTM, unidirectional and bidirectional,
    seeded weights: the card's B=128 forward at float32 and at TF32, its
    first CLS_CPU_ROWS rows held against the CPU's float32 and float64
    evaluations; forward ms and TFLOP/s."""
    x = torch.from_numpy(X[:CLS_BATCH])
    rows = []
    for bidir in (False, True):
        cpu = clf_models.build_classifier("lstm", device="cpu",
                                          **_lstm_kwargs(X.shape[-1], bidir))
        card = copy.deepcopy(cpu).to("cuda")
        xc = x.to("cuda")
        got, ms = {}, {}
        with torch.no_grad():
            for precision in ("float32", "tensorfloat32"):
                with infer.conv_matmul_precision(precision):
                    got[precision] = card(xc)[:CLS_CPU_ROWS].double().cpu()
                    ms[precision] = cuda_ms(lambda: card(xc), reps=3)
            del card, xc
            want = cpu(x[:CLS_CPU_ROWS]).double()
            ref = cpu.double()(x[:CLS_CPU_ROWS].double())
        del cpu
        err_cpu = float((want - ref).abs().max())
        err = {p: float((g - ref).abs().max()) for p, g in got.items()}
        # the spread behind the bound: each row's card error over the CPU's
        ratio = ((got["float32"] - ref).abs().flatten(1).amax(1)
                 / (want - ref).abs().flatten(1).amax(1)).sort().values
        flops = lstm_flops(CLS_BATCH, X.shape[1], X.shape[-1], CLS_HIDDEN, CLS_LAYERS,
                           1 + bidir)
        row = {"bidirectional": bidir, "batch": CLS_BATCH, "T": X.shape[1],
               "rows_held": CLS_CPU_ROWS, "logit_abs_max": float(ref.abs().max()),
               "err_cpu_float32_vs_float64": err_cpu,
               "err_card_float32_vs_float64": err["float32"],
               "err_card_tensorfloat32_vs_float64": err["tensorfloat32"],
               "card_vs_cpu_float32": float((got["float32"] - want).abs().max()),
               "ratio": err["float32"] / err_cpu,
               "row_ratio_min_median_max": [float(ratio[0]), float(ratio.median()),
                                            float(ratio[-1])],
               "bound": CLS_FWD_FACTOR * err_cpu, "tflop": flops * 1e-12,
               "forward_ms_float32": ms["float32"],
               "forward_ms_tensorfloat32": ms["tensorfloat32"],
               "tflops_float32": flops / ms["float32"] * 1e-9,
               "tflops_tensorfloat32": flops / ms["tensorfloat32"] * 1e-9}
        log("classifier forward " + json.dumps(row))
        if not err["float32"] <= CLS_FWD_FACTOR * err_cpu:
            raise AssertionError(f"classifier float32 forward on the card off: {row}")
        if not err["tensorfloat32"] > CLS_FWD_FACTOR * err_cpu:
            raise AssertionError(f"the classifier check cannot tell TF32 from float32: {row}")
        rows.append(row)
    return rows


def _cls_one_step(net, x, y):
    """(loss, state_dict after, effective gradients) of one step of ``net``
    (on its device, in its dtype), dropout 0, Adam with its coupled weight
    decay: the gradient Adam sees is g + wd * p."""
    p = next(net.parameters())
    p0 = {k: v.detach().double().cpu() for k, v in net.state_dict().items()}
    tr = clf_train.ClassifierTrainer(net, learning_rate=CLS_LR, weight_decay=CLS_WD)
    loss, _ = tr.train_step(torch.from_numpy(x).to(device=p.device, dtype=p.dtype),
                            torch.from_numpy(y - 1).to(p.device))
    grads = {k: v.grad.double().cpu() + CLS_WD * p0[k]
             for k, v in net.state_dict(keep_vars=True).items()}
    return float(loss), {k: v.detach().cpu() for k, v in net.state_dict().items()}, grads


def cls_step(X, Y):
    """One full-width unidirectional step (``CLS_STEP_LAYERS`` deep) from the
    seeded weights on the card, on the CPU and on the CPU in float64, held
    as the GAN steps are."""
    x, y = X[:CLS_STEP_BATCH], np.asarray(Y[:CLS_STEP_BATCH], np.int64)
    base = clf_models.build_classifier("lstm", device="cpu", dropout=0.0, **_lstm_kwargs(
        X.shape[-1], False, num_layers=CLS_STEP_LAYERS))
    card, cpu, ref = (_cls_one_step(copy.deepcopy(base).to(device=d, dtype=t), x, y)
                      for d, t in (("cuda", torch.float32), ("cpu", torch.float32),
                                   ("cpu", torch.float64)))
    return hold_step({"model": "ClassifLSTM", "step": "Adam", "batch": CLS_STEP_BATCH,
                      "layers": CLS_STEP_LAYERS}, card, cpu, ref, CLS_LR)


def _cls_metrics(models_dir):
    (name,) = [f for f in os.listdir(models_dir) if f.startswith("metrics_")]
    with open(os.path.join(models_dir, name)) as f:
        return [json.loads(line) for line in f]


def cls_cli(tmp, data_dir, X):
    """``classifier_main.main`` at its defaults (dropout 0.1) for CLS_EPOCHS
    epochs, twice with the same seeds: finite losses, identical per-epoch
    losses in the two runs, a best-val ``.pth`` that loads strictly, the
    CSV; then ``classifier_mlp_main.main``."""
    cwd = os.getcwd()
    os.chdir(tmp)  # the CLIs write GT_predY.csv to the working directory
    try:
        runs = []
        for run in ("a", "b"):
            args = classifier_main.build_parser().parse_args([
                "--data_dir", data_dir, "--models_dir", os.path.join(tmp, f"models_{run}"),
                "--num_epochs", str(CLS_EPOCHS), "--device", "cuda"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            best = classifier_main.main(args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs.append(_cls_metrics(args.models_dir))
            log(f"classifier_main.main (hidden {args.hidden_size}, {args.num_layers} layers, "
                f"bidir {args.bidir}, B={args.batch_size}, dropout {args.dropout}): "
                f"{CLS_EPOCHS} epochs in {wall:.3f} s, best val acc {best:.4f}; "
                + "; ".join(json.dumps({k: r[k] for k in ("epoch", "loss_train", "loss_val",
                                                           "acc_train", "acc_val")})
                            for r in runs[-1]))
        losses = [[(r["loss_train"], r["loss_val"]) for r in rows] for rows in runs]
        if not all(np.isfinite(v).all() for v in losses) or len(losses[0]) != CLS_EPOCHS:
            raise AssertionError(f"classifier CLI: bad losses {losses}")
        if losses[0] != losses[1]:
            raise AssertionError(f"classifier CLI: two runs with the same seeds differ {losses}")
        ckpt = os.path.join(args.models_dir, f"{args.exp_name}_checkpoint.pth")
        fresh = clf_models.build_classifier("lstm", device="cuda", seed=0,
                                            **_lstm_kwargs(X.shape[-1], False))
        fresh.load_state_dict(ckpt_lib.load_classifier_state(ckpt), strict=True)
        with open(os.path.join(tmp, "GT_predY.csv"), encoding="ISO-8859-1") as f:
            n_csv = sum(1 for _ in f) - 1
        log(f"classifier checkpoint {os.path.basename(ckpt)} loads strictly; "
            f"GT_predY.csv {n_csv} rows; the two runs' losses identical")

        margs = classifier_mlp_main.build_parser().parse_args([
            "--data_dir", data_dir, "--models_dir", os.path.join(tmp, "models_mlp"),
            "--num_epochs", str(CLS_EPOCHS), "--device", "cuda"])
        best = classifier_mlp_main.main(margs)
        rows = _cls_metrics(margs.models_dir)
        log(f"classifier_mlp_main.main: {CLS_EPOCHS} epochs, best val acc {best:.4f}; "
            + "; ".join(f"epoch {r['epoch']} loss {r['loss_train']:.6f} / {r['loss_val']:.6f}"
                        for r in rows))
        if len(rows) != CLS_EPOCHS or not all(np.isfinite([r["loss_train"], r["loss_val"]]).all()
                                              for r in rows):
            raise AssertionError(f"classifier_mlp_main: bad losses {rows}")
    finally:
        os.chdir(cwd)


def cls_rates(X, Y, Xv, Yv):
    """Steps/s and frames/s of train and val epochs at the CLI's defaults,
    resident, with the peak memory of training; one train step traced."""
    net = clf_models.build_classifier("lstm", device="cuda",
                                      **_lstm_kwargs(X.shape[-1], False, dropout=0.1))
    tr = clf_train.ClassifierTrainer(net)
    dX, dY = tr.stage(X, Y)
    vX, vY = tr.stage(Xv, Yv)
    order = np.arange(len(X))
    for kind, reps, epoch, n in (
            ("train", 2, lambda: tr.train_epoch_resident(dX, dY, order, CLS_BATCH), len(X)),
            ("val", 3, lambda: tr.val_epoch_resident(vX, vY, CLS_BATCH), len(Xv))):
        epoch()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(reps):
            epoch()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        steps = reps * (n // CLS_BATCH)
        log(f"classifier rate {kind} epoch (resident, B={CLS_BATCH}, T={X.shape[1]}, float32): "
            f"{steps} steps in {dt:.3f} s = {steps / dt:.3f} steps/s, "
            f"{steps * CLS_BATCH * X.shape[1] / dt:.1f} frames/s, "
            f"{dt / steps * 1e3:.1f} ms a step; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    # one step traced, not the epoch: the profiler's host cost grows with the
    # RNN's many small kernels
    log_trace(f"one classifier train step of B={CLS_BATCH} (resident)",
              *profiled(lambda: tr.train_epoch_resident(dX, dY, order[:CLS_BATCH],
                                                        CLS_BATCH)), "RNN")


def cls_learns(tmp):
    """The JAX package's learning bars on the card: a small LSTM (hidden 64,
    1 layer, Adam 3e-3) and the sentence MLP (Adam 1e-3) on categ_signal
    fixtures, best val accuracy within 60 epochs."""
    best = {}
    for kind, kw, bar in (
            ("lstm", dict(t_range=(60, 140)), CLS_LSTM_BAR),
            ("mlp", dict(t_range=(40, 60), text_dim=384), CLS_MLP_BAR)):
        d = os.path.join(tmp, f"learn_{kind}")
        synthetic.make_r6d_dataset(d, n_clips=54, seed=7, save_image_feats=False,
                                       categ_signal=True, device="cuda", **kw)
        if kind == "lstm":
            (X, Y), (Xv, Yv) = (clf_train.load_data(d, "r6d", k) for k in ("train", "val"))
            net = clf_models.build_classifier("lstm", seed=0, device="cuda",
                                              input_size=X.shape[-1], hidden_size=64,
                                              num_layers=1, bidirectional=False)
            tr = clf_train.ClassifierTrainer(net, learning_rate=3e-3, weight_decay=0.0)
        else:
            (X, Y), (Xv, Yv) = (classifier_mlp_main.load_mlp_data(d, k)
                                for k in ("train", "val"))
            net = clf_models.build_classifier("mlp", seed=0, device="cuda")
            tr = clf_train.ClassifierTrainer(net, learning_rate=1e-3, weight_decay=0.0,
                                             last_timestep_only=False)
        accs = []
        for _ in range(60):
            tr.train_epoch(X, Y, 16)
            accs.append(tr.val_epoch(Xv, Yv, 16)[1])
        best[kind] = max(accs)
        log(f"classifier learns ({kind}): best val acc {best[kind]:.4f} over 60 epochs "
            f"(bar {bar}); every 10th epoch {accs[::10]}")
        if not best[kind] > bar:
            raise AssertionError(f"the {kind} classifier did not learn on the card: {best}")
    return best


def cls_remat(data_dir, D):
    """Remat at the grouped_r6d window: a batch of CLS_REMAT_BATCH clips of
    T=2112 (grouped from the train clips, as Truer6d_train.pkl), one
    CE-on-last-timestep backward at full width with and without remat:
    logits and gradients equal to the bit, peak memory lower with remat.
    Then the peak of one bidirectional B=128, T=192 step, with and without
    remat, and ``should_remat``'s answers on the card."""
    clips = io.load_binary(os.path.join(data_dir, "r6d_train.pkl"))
    categs = io.load_binary(os.path.join(data_dir, "categs_train.pkl"))
    per = -(-CLS_GROUPED_T // min(c.shape[0] for c in clips))  # clips a group
    groups = [np.concatenate(clips[i * per:(i + 1) * per]) for i in range(CLS_REMAT_BATCH)]
    io.save_binary(groups, os.path.join(data_dir, "Truer6d_train.pkl"))
    io.save_binary([categs[i * per] for i in range(CLS_REMAT_BATCH)],
                   os.path.join(data_dir, "Truecategs_train.pkl"))
    X, Y = clf_train.load_data(data_dir, "grouped_r6d", "train")
    if X.shape != (CLS_REMAT_BATCH, CLS_GROUPED_T, D):
        raise AssertionError(f"grouped batch {X.shape}")

    def backward(x, y, bidir, remat):
        net = clf_models.build_classifier("lstm", device="cuda", dropout=0.0, remat=remat,
                                          **_lstm_kwargs(D, bidir)).train()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        with infer.conv_matmul_precision("float32"):
            out = net(x)
            torch.nn.functional.cross_entropy(out[:, -1], y).backward()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        grads = {k: p.grad for k, p in net.state_dict(keep_vars=True).items()}
        return out.detach(), grads, peak, wall

    x = torch.from_numpy(X).to("cuda")
    y = torch.from_numpy(np.asarray(Y, np.int64) - 1).to("cuda")
    plain = backward(x, y, False, False)
    remat = backward(x, y, False, True)
    same_out = torch.equal(plain[0], remat[0])
    same_grad = all(torch.equal(g, remat[1][k]) for k, g in plain[1].items())
    row = {"batch": CLS_REMAT_BATCH, "T": CLS_GROUPED_T, "bidirectional": False,
           "logits_equal": same_out, "grads_equal": same_grad,
           "logit_diff": float((plain[0] - remat[0]).abs().max()),
           "peak_gib_plain": plain[2] / 2**30, "peak_gib_remat": remat[2] / 2**30,
           "s_plain": plain[3], "s_remat": remat[3],
           "estimate_gib_plain": clf_train.lstm_activation_bytes(
               CLS_REMAT_BATCH, CLS_GROUPED_T, CLS_HIDDEN, CLS_LAYERS, False) / 2**30}
    del plain, remat, x, y
    xb = torch.from_numpy(np.stack([c[:WINDOW_T] for c in clips[:CLS_BATCH]])).to("cuda")
    yb = torch.from_numpy(np.asarray(categs[:CLS_BATCH], np.int64) - 1).to("cuda")
    for remat in (False, True):
        _, _, peak, wall = backward(xb, yb, True, remat)
        row[f"bidir_b128_t192_peak_gib_{'remat' if remat else 'plain'}"] = peak / 2**30
        row[f"bidir_b128_t192_s_{'remat' if remat else 'plain'}"] = wall
    row["bidir_b128_t192_estimate_gib"] = clf_train.lstm_activation_bytes(
        CLS_BATCH, WINDOW_T, CLS_HIDDEN, CLS_LAYERS, True) / 2**30
    row["should_remat_b128"] = {
        f"T{t}_{'bidir' if b else 'unidir'}": clf_train.should_remat(
            CLS_BATCH, t, CLS_HIDDEN, CLS_LAYERS, b, device="cuda")
        for t in (WINDOW_T, CLS_GROUPED_T) for b in (False, True)}
    log("classifier remat " + json.dumps(row))
    if not (same_out and same_grad):
        raise AssertionError(f"remat changed the LSTM's logits or gradients: {row}")
    if not row["peak_gib_remat"] < row["peak_gib_plain"]:
        raise AssertionError(f"remat did not lower the peak memory: {row}")
    return row


def classifier_phase():
    """The downstream classifiers on the card: seeded r6d clips with
    learnable categories and 384-wide sentence embeddings, written by the
    port's ``data/synthetic``; the full-width forward and one step against
    the CPU, both CLIs, rates, learning, remat."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cls_") as tmp:
        data_dir = os.path.join(tmp, "video_data")
        t0 = time.perf_counter()
        synthetic.make_r6d_dataset(data_dir, n_clips=CLS_TRAIN_CLIPS, t_range=(192, 256),
                                       seed=SEED, text_dim=384, save_image_feats=False,
                                       categ_signal=True, device="cuda")
        (X, Y), (Xv, Yv) = (clf_train.load_data(data_dir, "r6d", k) for k in ("train", "val"))
        log(f"classifier data: train {X.shape}, val {Xv.shape} in "
            f"{time.perf_counter() - t0:.1f} s")
        for name, part in (("forward", lambda: cls_forward(X)), ("step", lambda: cls_step(X, Y)),
                           ("CLIs", lambda: cls_cli(tmp, data_dir, X)),
                           ("rates", lambda: cls_rates(X, Y, Xv, Yv)),
                           ("learning", lambda: cls_learns(tmp)),
                           ("remat", lambda: cls_remat(data_dir, X.shape[-1]))):
            t0 = time.perf_counter()
            part()
            log(f"classifier {name}: {time.perf_counter() - t0:.1f} s")


# replay phase: the port's article replay at --scale small, full width
# Batches of 128 (GAN) and 64 (classifiers), not the replay's 256 and 128:
# the small scale's 64 val windows fill no half batch of 128 and no val batch
# of 128, so at the defaults no val step would run (every best val 0, every
# accuracy 0; the reference's integer division).  Widths are the defaults.
REPLAY_ARGS = ["--scale", "small", "--batch_size", "128", "--classifier_batch", "64",
               "--epochs", "4", "--finger_epochs", "4", "--classifier_epochs", "10",
               "--signal_fixture", "--finger_signal", "--fingers", "1,2,3",
               "--reference_classifier", "--reference_classifier_epochs", "1",
               "--anomaly_controls", "--device", "cuda"]
REPLAY_RAW_CYCLES = 60  # the replay's raw smoke (article_replay.stage_raw_smoke)
REPLAY_RAW_PARTITIONS = 2
ARTICLE_BATCH = 256  # the replay's default --batch_size, the article's
FIXTURE_ATOL = {"r6d_": 1e-4, "xyz_": 1e-5}  # test_synthetic_dataset_matches_jax


def replay_robust_shapes():
    """The (N, T * D_out) residuals robust_loss sees in the replay phase: the
    G and val steps of v2+text (K = 1) and of each K of the sweep, plus the
    article's batch and the last partial batch of an article-scale epoch
    (which the trainer drops)."""
    args = article_replay.build_parser().parse_args(REPLAY_ARGS)
    ks = article_replay._parse_fingers(args.fingers)
    shapes = {(n, WINDOW_T * 24 * k) for k in ks
              for n in (args.batch_size, args.batch_size // 2)}
    partial = article_replay.SCALES["article"]["train"] % ARTICLE_BATCH
    return sorted(shapes | {(ARTICLE_BATCH, WINDOW_T * 24), (partial, WINDOW_T * 24)})


def hold_fixture(card_dir, tmp, fixture):
    """The replay's fixture made on the card against the same fixture made
    on the CPU (``fixture``: the report's entry for it): r6d within 1e-4,
    xyz within 1e-5, everything else equal.  Returns the largest r6d and xyz
    differences, and where each lies."""
    cpu_dir = os.path.join(tmp, "fixture_cpu")
    synthetic.make_r6d_dataset(cpu_dir, split_counts=fixture["counts"], seed=7,
                               save_image_feats=True, ik_roundtrip=True,
                               categ_signal=fixture["categ_signal"],
                               finger_signal=fixture["finger_signal"], device="cpu")
    names = sorted(f for f in os.listdir(card_dir) if f.endswith(".pkl"))
    if names != sorted(os.listdir(cpu_dir)):
        raise AssertionError(f"fixture files differ: {names} vs {sorted(os.listdir(cpu_dir))}")
    worst = {"r6d_": 0.0, "xyz_": 0.0}
    where = {}
    for name in names:
        card, cpu = (io.load_binary(os.path.join(d, name)) for d in (card_dir, cpu_dir))
        if len(card) != len(cpu):
            raise AssertionError(f"{name}: {len(card)} entries on the card, {len(cpu)} on the CPU")
        kind = name[:4]
        for clip, (a, b) in enumerate(zip(card, cpu)):
            a, b = np.asarray(a), np.asarray(b)
            if a.shape != b.shape:
                raise AssertionError(f"{name}: shapes {a.shape} and {b.shape}")
            if kind in FIXTURE_ATOL:
                err = np.abs(a - b)
                if err.max() > worst[kind]:
                    frame, col = np.unravel_index(int(err.argmax()), err.shape)
                    worst[kind] = float(err.max())
                    where[kind] = {"file": name, "clip": clip, "frame": int(frame),
                                   "column": int(col), "cpu": float(b[frame, col]),
                                   "card": float(a[frame, col])}
            elif not np.array_equal(a, b):
                raise AssertionError(f"{name}: the card's fixture differs from the CPU's")
    if not all(worst[k] <= FIXTURE_ATOL[k] for k in worst):
        raise AssertionError(f"fixture on the card vs the CPU: {worst} over {FIXTURE_ATOL} "
                             f"at {where}")
    return worst, where


def check_replay_report(report):
    """Complete, with finite L1 on every split of both configurations and of
    each K, and accuracies in [0, 1]."""
    bad = []
    if not (report.get("completed") and report.get("core_completed")):
        bad.append("not completed")
    for name in (c["name"] for c in article_replay.CONFIGS):
        l1 = report["configs"][name]["inference"]["L1"]
        if sorted(l1) != ["test", "train", "val"] or not all(map(np.isfinite, l1.values())):
            bad.append(f"{name} L1 {l1}")
    for k in article_replay._parse_fingers(REPLAY_ARGS[REPLAY_ARGS.index("--fingers") + 1]):
        l1 = report["finger_trend"][str(k)]["inference"]["L1"]
        if sorted(l1) != ["test", "val"] or not all(map(np.isfinite, l1.values())):
            bad.append(f"K={k} L1 {l1}")
    cls = report["classifier"]
    accs = {key: cls[key]["best_val_acc"] for key in (
        "ground_truth_r6d", "enhanced_r6d", "enhanced_r6d_reference_config", "text_mlp")}
    accs.update({f"control {key}": v["best_val_acc"]
                 for key, v in cls["anomaly_controls"].items() if key != "explanation"})
    if len(accs) != 8 or not all(0.0 <= a <= 1.0 for a in accs.values()):
        bad.append(f"accuracies {accs}")
    # the val steps ran: a val epoch of no batch reads 0
    best = [e["train"]["best_val"] for e in (*report["configs"].values(),
                                             *report["finger_trend"].values())]
    if not all(np.isfinite(b) and b > 0 for b in best):
        bad.append(f"best val losses {best}")
    if not 0 < max(accs.values()):
        bad.append(f"no classifier classified a val window: {accs}")
    if bad:
        raise AssertionError(f"the replay's report is incomplete: {bad}")
    return accs


def replay_phase(fp32, robust_rows):
    """The port's article replay on the card at ``--scale small`` (256 / 64 /
    64 clips), full width (generators 256 wide, the replay's 256x2
    classifier, the reference classifier 1024x10 bidirectional for one
    epoch), with the signal fixtures, fingers 1-3 and the anomaly controls;
    both kernels' counts at 0 just before.  Checked: the card's fixture
    against the CPU's; the report; ``filter_sgd`` on every raw-smoke batch
    with that batch's own inputs at 60 cycles; that every shape the replay
    launched ``robust_loss`` at is among ``robust_rows``, the kernel held
    against its plain version at ``replay_robust_shapes()``.  Returns each
    kernel's replay entries."""
    shapes = set()
    launch = rl.robust_loss_and_dx

    def recording(x, alpha, scale):
        shapes.add(tuple(x.shape))
        return launch(x, alpha, scale)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_replay_") as tmp:
        work, out = os.path.join(tmp, "work"), os.path.join(tmp, "replay.json")
        args = article_replay.build_parser().parse_args(
            REPLAY_ARGS + ["--work_dir", work, "--out", out])
        cwd = os.getcwd()
        os.chdir(tmp)  # the CLIs write root.pkl, bone_len.pkl and GT_predY.csv here
        rl.robust_loss_and_dx = recording
        try:
            fs.filter_sgd.launches = 0  # counts of the replay start here
            rl.robust_lossfun.launches = 0
            t0 = time.perf_counter()
            report = article_replay.main(args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {"filter_sgd": fs.filter_sgd.launches,
                        "robust_loss": rl.robust_lossfun.launches}
        finally:
            rl.robust_loss_and_dx = launch
            os.chdir(cwd)
        log(f"replay: {wall:.1f} s, launches {launches}, robust_loss shapes {sorted(shapes)}")
        if not all(launches.values()):
            raise AssertionError(f"a kernel of the replay path never launched: {launches}")
        accs = check_replay_report(report)

        t0 = time.perf_counter()
        fixture_err, fixture_worst = hold_fixture(os.path.join(work, "video_data"), tmp,
                                                  report["fixture"])
        log(f"replay fixture card vs CPU: max |r6d| {fixture_err['r6d_']:.3e}, max |xyz| "
            f"{fixture_err['xyz_']:.3e}, everything else equal "
            f"({time.perf_counter() - t0:.1f} s); worst entries {json.dumps(fixture_worst)}")
        raw_dir = os.path.join(work, "raw_processed")
        filter_rows = []
        for split in ("train", "val", "test"):
            feats = io.load_binary(os.path.join(raw_dir, f"xy_{split}.pkl"))
            for tb, chunk in raw_batches(feats, REPLAY_RAW_PARTITIONS):
                kps, masks, noises = (torch.from_numpy(a).to("cuda")
                                      for a in engine._pack(chunk, tb))
                filter_rows.append(hold_filter(
                    engine._init_core(kps, masks, noises) + (masks,), len(chunk),
                    "replay raw batch", fp32, reps=20, n_cycles=REPLAY_RAW_CYCLES))
        held = {(r["N"], r["D"]) for r in robust_rows}
        if not shapes:
            raise AssertionError("no robust_loss call of the replay was recorded: the trainer "
                                 "no longer reaches rl.robust_loss_and_dx")
        if not shapes <= held:
            raise AssertionError(f"robust_loss ran at shapes never held: {shapes - held}")
        held_launches = sum(r["launches"] for r in filter_rows)
        if held_launches != launches["filter_sgd"]:
            raise AssertionError(f"the raw-smoke batches held launch filter_sgd {held_launches} "
                                 f"times, the replay {launches['filter_sgd']}")

    summary = {
        "scale": report["scale"], "wall_s": wall, "launches": launches,
        "stages_s": {
            "raw_smoke": report["raw_pipeline_smoke"]["wall_s"],
            "fixture": report["fixture"]["wall_s"],
            **{f"train {k}": e["train"]["wall_s"] for k, e in report["configs"].items()},
            **{f"infer {k}": sum(e["inference"]["wall_s"].values())
               for k, e in report["configs"].items()},
            **{f"classifier {k}": v["wall_s"] for k, v in report["classifier"].items()
               if isinstance(v, dict) and "wall_s" in v},
            **{f"classifier control {k}": v["wall_s"]
               for k, v in report["classifier"]["anomaly_controls"].items()
               if isinstance(v, dict)},
            **{f"trend K={k} train": e["train"]["wall_s"]
               for k, e in report["finger_trend"].items()},
            **{f"trend K={k} infer": sum(e["inference"]["wall_s"].values())
               for k, e in report["finger_trend"].items()},
        },
        "L1": {k: e["inference"]["L1"] for k, e in report["configs"].items()},
        "best_val": {k: e["train"]["best_val"] for k, e in report["configs"].items()},
        "classifier_val_acc": accs,
        "classifier_windows": report["classifier"]["windows"],
        "finger_trend": report["finger_trend_vs_article"],
        "fixture_max_abs": fixture_err,
        "fixture_worst_entries": fixture_worst,
    }
    print(json.dumps({"replay": summary}), flush=True)
    keep = ("B", "T", "n_cycles", "launches", "ms", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err")
    return {
        "filter_sgd": {"launches_replay": launches["filter_sgd"],
                       "replay_held": [{k: r[k] for k in keep} for r in filter_rows]},
        "robust_loss": {"launches_replay": launches["robust_loss"],
                        "replay_shapes": sorted(shapes),
                        "replay_held": [{k: r[k] for k in keep if k in r} | {
                            "N": r["N"], "D": r["D"],
                            "max_err_over_tol": max(r["loss_err_over_tol"],
                                                    r["dx_err_over_tol"])}
                            for r in robust_rows]},
    }


def profiled(fn):
    """Run ``fn`` under torch.profiler: (wall s, {kernel name: device s},
    device busy s).  The busy time is the union of the CUDA kernels' spans:
    cuDNN's RNNs run kernels on streams of their own, so spans can overlap
    and their sum can exceed the wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict = {}
    spans = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() * 1e-6
            spans.append((e.time_range.start, e.time_range.end))
    busy, reach = 0, None
    for start, end in sorted(spans):
        if reach is None or start > reach:
            busy, reach = busy + end - start, end
        elif end > reach:
            busy, reach = busy + end - reach, end
    return wall, by_name, busy * 1e-6


def log_trace(label, wall, by_name, busy, kernel):
    """One line for a traced window: wall, device busy, idle share, the time
    in the kernels whose name holds ``kernel``, and the top five."""
    if busy <= 0:
        log(f"trace {label}: wall {wall:.3f} s; device time not measured "
            "(the profiler saw no CUDA kernels)")
        return
    own = sum(v for k, v in by_name.items() if kernel in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    log(f"trace {label}: wall {wall:.3f} s, device busy {busy:.3f} s "
        f"(idle share {1 - busy / wall:.3f}; kernel time summed {sum(by_name.values()):.3f} s), "
        f"{kernel} {own:.4f} s; top: "
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
    rng = np.random.RandomState(SEED + 2)
    replay_robust = [hold_robust(N, D, rng) for N, D in replay_robust_shapes()]
    prod, path = kernel_phase(clips, fp32)
    launches, xyz, r6d = path_phase(clips)
    t0 = time.perf_counter()
    raw_launches, raw = raw_phase(fp32)
    log(f"raw phase: {time.perf_counter() - t0:.1f} s")
    robust_launches = train_phase(r6d)
    t0 = time.perf_counter()
    robust_launches += conditioned_phase(xyz, r6d)
    log(f"conditioned phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    classifier_phase()
    log(f"classifier phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    replay = replay_phase(fp32, replay_robust)
    log(f"replay phase: {time.perf_counter() - t0:.1f} s")

    main_row = prod[-1]  # B=128, T=1920: the longest production bucket
    robust_row = robust[0]  # (128, 48384): the G step's residual
    kernels = [{
        "name": "filter_sgd",
        "route": "cuda",
        "source": "multimodal_hand_pose_enhancement_for_sign_language_tpu_torch/csrc/filter_sgd.cu",
        "replaces": "multimodal_hand_pose_enhancement_for_sign_language_tpu/ops/pallas_kernels.py:203",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in
                           prod + path + raw + replay["filter_sgd"]["replay_held"]),
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
        # the raw-data path (process_dataset --lift), its counts read alone
        "launches_raw": raw_launches,
        "raw_path_ms": sum(r["ms"] for r in raw),
        "longest_T_held": max(r["T"] for r in raw),
        "long_rows": [{k: r[k] for k in ("B", "T", "launch_plan", "launches", "ms",
                                         "bound_ms", "max_abs_err")}
                      for r in raw if len(r["launch_plan"]) == 6],
        # the article replay (its raw smoke at 60 cycles), its counts read alone
        **replay["filter_sgd"],
    }, {
        "name": "robust_loss",
        "route": "cuda",
        "source": "multimodal_hand_pose_enhancement_for_sign_language_tpu_torch/csrc/robust_loss.cu",
        "replaces": "multimodal_hand_pose_enhancement_for_sign_language_tpu/ops/pallas_kernels.py:278",
        "launches": robust_launches,
        # the largest difference in loss or dx over the held shapes; the
        # values themselves reach 1e13 there (c down to 1e-3), and each is
        # held relative to its size (loss/dx_err_over_tol in the rows above)
        "max_abs_err": max(r["max_abs_err"] for r in
                           robust + replay["robust_loss"]["replay_held"]),
        "max_err_over_tol": max([max(r["loss_err_over_tol"], r["dx_err_over_tol"])
                                 for r in robust]
                                + [r["max_err_over_tol"]
                                   for r in replay["robust_loss"]["replay_held"]]),
        "ms": robust_row["ms"],
        "plain_ms": robust_row["plain_ms"],
        "bound_ms": robust_row["bound_ms"],
        "bound_by": robust_row["bound_by"],
        "library_ms": None,  # no single PyTorch call computes rho and its dx
        "launch_plan": robust_row["launch_plan"],
        # the article replay (v2+text and the finger sweep), its counts read alone
        **replay["robust_loss"],
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
