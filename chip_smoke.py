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
reference-config classifier (bidirectional, then unidirectional) for one
epoch each and the anomaly controls (``--seqs_to_viz 0`` where matplotlib or
PIL is missing; with both, each test split's two GIFs): the
fixture made on the card (held against the same fixture made on the CPU),
the raw smoke through ``process_dataset --lift`` at 60 cycles, both
canonical configs trained and served, the classifiers, the finger trend.
Checked: both kernels launched in the replay, the report complete (finite
L1 on every split, val steps run, accuracies in [0, 1]), ``filter_sgd`` on
every raw-smoke batch against its plain version, ``robust_loss`` held at
the replay's residual shapes, a ``--resume`` that runs no stage again; a
``{"replay": ...}`` line carries the stage times and the table-shaped
numbers.

Featurizers: seeded random weights at the widths the JAX routes default to
(MiniLM-L6 384x6, bert-base 768x12 at 512 tokens, CLIP ViT-B/32's text
512x12 and vision 768x12 towers, ResNet-50), written by the port's
``data/synthetic`` as local snapshots (config.json, a 30,522-token
vocab.txt or a CLIP vocab.json / merges.txt, pytorch_model.bin) and a
torchvision ``.pth``: ``data/text.obtain_embeddings`` for BERTsentence,
BERTword and clip on seeded sentences, ``obtain_cropped_clips`` on seeded
1280x720 frames and OpenPose hand keypoints, then ``obtain_feats_crops_resnet``
and ``obtain_feats_crops_clip``, and ``process_dataset.main --vid_feats`` over
a crops pickle.  Each output is held against the port's CPU path on the same
weights at 2^-15 of its largest value (ResNet-50, where cuDNN breaks that,
against a float64 CPU evaluation: at most twice the CPU's float32 error);
bert-base under TF32 must miss the bound; rates of each tower.  Neither
kernel lies on this path (its launch counts, read alone, are 0).

Lifting alternatives (after serving): ``python -m ...demo`` (the
single-clip v2 API) on the card against the CPU on its synthetic 64 frames
and a seeded 1,920-frame sequence (x, y within 2e-4, z within 2e-3;
``filter_sgd`` launches counted).

Options (after training): v1's and v4_deeper+text's bf16 forwards against
float32 (the JAX package's bars: max < 0.15, mean < 0.02) and timed at
B=2048; ``train_gan.main --bf16 --log_grad_flow 1`` for v1 at B=128, 2
epochs (``robust_loss`` launches counted, master weights and Adam state
float32, the grad-flow events finite, one residual of the run held against
the plain version), ``inference.main`` from its checkpoint with and without
``--bf16`` (end-to-end MPJPE reported); one bf16 G step within 5% of the
float32 one, each tensor's bf16 G and D gradient within 0.75 of the float32
step's (in norm, relative); one ``fused_d`` D step against the sequential
one (loss 1e-5 relative, statistics 5e-6, gradients 2^-6); G, D and val rates at float32 and bf16 and D
fused, in turns; float64 clips through ``load_data`` against the JAX legacy
route's arrays (``tests/data/load_data_float64_ref.npz``).

Viz (on the training checkpoint): whether matplotlib and PIL import here,
and the case that allows: with both, ``inference --seqs_to_viz 2`` and
``viz_gt`` in both modes render (GIF names, frame counts, durations;
``viz_gt``'s xyz card vs CPU within 1e-3 MPJPE); without either,
``inference --seqs_to_viz 2`` and ``viz_gt --file_path`` must exit nonzero
before any work naming the package, and ``--seqs_to_viz 0`` must serve.

Utils (after training): ``nan_guard.tree_check_finite`` on a trainer's CUDA
state after one G step (nothing; one NaN planted in a gradient, by name),
``profiling.trace`` around one G step (``robust_loss_kernel`` and a
``span`` region in its Chrome trace), ``ops/build.library``'s name
under another toolchain text.

Mesh (after training): the multi-device paths (``parallel/``) in-process
on a one-rank NCCL group (a FileStore rendezvous), each against the same
path without a mesh on the card: the DP and TP G and D steps of v1 arm2wh at
B=128 at the step tolerances (the mask: entries whose gradient lies within
4x the two evaluations' disagreement) and their val steps, the DP G step
also as the plain card step is held (``hold_step``: against the CPU's
float32 step and float64 on its own and the CPU's branches), the classifier's
DP step (1024x10 bidirectional, B=4), sharded ``run_inference`` at B=2048
(2^-15 of the largest output), the serving clips' sharded ``lift_clips``
(1e-6; ``filter_sgd`` launches counted), ``filter_xyz_time_sharded`` on an
8,704-frame clip at 900 cycles against ``filter_sgd`` with an all-ones mask
(2e-4), one DP G step traced (its collectives, NCCL's device time, one
``robust_loss`` launch); then ``train_gan`` (2 epochs) and ``inference``
under ``python -m torch.distributed.run --standalone --nproc_per_node=1``
against the one-process CLIs (epoch losses 1e-3 relative, L1 1e-5, xyz
MPJPE within the 1e-3 budget).  ``nccl_two_ranks_one_card()`` (not run by
``main``) starts two NCCL ranks on the one card and reports how that ends.

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
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from io import BytesIO

import numpy as np
import torch
import torch.distributed as dist
from torch.overrides import TorchFunctionMode

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch import (
    article_replay,
    classifier_main,
    classifier_mlp_main,
    demo,
    infer,
    inference,
    process_dataset,
    train_gan,
    viz_gt,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data import (
    io,
    openpose,
    standardize,
    synthetic as synthetic,
    text,
    tokenizers,
    video,
    windows,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.lifting import engine
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.losses.robust import (
    AdaptiveLossFunction,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models import (
    classifier as clf_models,
    clip_vision,
    registry,
    resnet as resnet_lib,
    text_encoders,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops import (
    build,
    filter_sgd as fs,
    kinematics,
    lift_init as li,
    robust_loss as rl,
    rotations,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.parallel import (
    mesh as mesh_lib,
    sequence,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.runtime import native
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.train import (
    checkpoint as ckpt_lib,
    classifier as clf_train,
    data as data_lib,
    gan,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils import (
    nan_guard,
    profiling,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.constants import (
    ARMS,
    DATA_PATHS,
    HANDS,
    NECK,
    WINDOW_T,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.viz import viz_3d

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


def bits_equal(a, b):
    """Equal bit for bit, or NaN where the other is NaN."""
    a, b = a.contiguous(), b.contiguous()
    same = (a.view(torch.int32) == b.view(torch.int32)) | (a.isnan() & b.isnan())
    return bool(same.all())


def launches_in(fn):
    """CUDA kernel launches the host makes in ``fn()``, counted by
    ``torch.profiler`` (the runtime's launch calls)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if "LaunchKernel" in e.key)


def hold_lift_init(kps, masks, noises, label, reps=3):
    """``lift_init``'s kernel against its plain version on the card, on one
    batch's own inputs (``engine._init_inputs``): equal bit for bit, NaN
    where the plain version gives NaN (the all-masked padding rows).
    Returns (the kernel's ``_init_core`` planes, the measured row)."""
    Xx, Xy, Xw, *walk = engine._init_inputs(kps, masks, noises)
    ins = (Xx, Xy, *walk)
    before = li.lift_init.launches
    got = li.lift_init(*ins)
    launches = li.lift_init.launches - before
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    want = li.lift_init_plain(*ins)
    t1.record()
    torch.cuda.synchronize()
    equal = all(bits_equal(g, w) for g, w in zip(got, want))
    ms = cuda_ms(lambda: li.lift_init(*ins), reps=reps)
    li.lift_init.launches = before + launches  # timing, not the path
    B, T = masks.shape
    byte_s = (li.BYTES_PER_FRAME * B * T + 4 * B * (li.J - 1)) / PEAK_BYTES
    flop_s = li.FLOPS_PER_FRAME * B * T / PEAK_FP32_FLOPS
    row = {"inputs": label, "B": B, "T": T, "launches": launches, "bit_equal": equal,
           "ms": ms, "plain_ms": t0.elapsed_time(t1), "bound_ms": 1e3 * max(flop_s, byte_s),
           "bound_by": "operations" if flop_s >= byte_s else "bytes"}
    log("kernel lift_init " + json.dumps(row))
    if not (equal and launches == 1):
        raise AssertionError(f"lift_init disagrees with its plain version: {row}")
    return got + (Xx, Xy, Xw), row


def lift_init_production():
    """``lift_init`` at B=128 for T=256 and 1920 (128 seeded clips of T
    frames each, packed and normalised as the engine does), and the launches
    of one such batch's ``_init_core`` with the kernel and with the plain
    walk in its place.  Returns the rows."""
    rng = np.random.RandomState(SEED + 7)
    rows = []
    for T in (256, 1920):
        chunk = [(i, c) for i, c in enumerate(synthetic_clips_of(rng, 128, T))]
        kps, masks, noises = (torch.from_numpy(a).to("cuda") for a in engine._pack(chunk, T))
        _, row = hold_lift_init(kps, masks, noises, "production", reps=20)
        before = li.lift_init.launches
        row["init_core_launches"] = launches_in(lambda: engine._init_core(kps, masks, noises))
        li.lift_init.launches = before  # a count, not the path

        def plain():
            Xx, Xy, _, *walk = engine._init_inputs(kps, masks, noises)
            li.lift_init_plain(Xx, Xy, *walk)

        row["init_core_launches_plain"] = launches_in(plain)
        log(f"lift.init launches a batch at B=128, T={T}: "
            f"{row['init_core_launches_plain']} with the plain walk, "
            f"{row['init_core_launches']} with the kernel")
        rows.append(row)
    return rows


def kernel_phase(clips, fp32):
    """CUDA filter_sgd against its plain version at 900 cycles: at the
    production shapes B=128, T in {64, 256, 1920} (random planes, masked
    tails), then on every batch the lifting path launches for ``clips``,
    with that batch's own inputs (the engine's plan, packing and
    initialization, ``lift_init`` held bit for bit on each).  Returns
    (production rows, path rows, ``lift_init``'s path rows)."""
    rng = np.random.RandomState(SEED)
    prod = [hold_filter(filter_inputs(rng, 128, T, "cuda"), 128, "random", fp32)
            for T in (64, 256, 1920)]
    path, init_path = [], []
    for tb, chunk in engine._plan(clips):
        kps, masks, noises = (torch.from_numpy(a).to("cuda")
                              for a in engine._pack(chunk, tb))
        planes, init_row = hold_lift_init(kps, masks, noises, "path batch")
        init_path.append(init_row)
        path.append(hold_filter(planes + (masks,), len(chunk), "path batch", fp32, reps=3))
    plans = sorted({tuple(r["launch_plan"].values()) for r in path})
    log(f"filter_sgd on the path's {len(path)} batches: launch plans (K, L, W, R) "
        f"{plans}, max_abs_err {max(r['max_abs_err'] for r in path):.3e}, kernel "
        f"{sum(r['ms'] for r in path):.3f} ms summed, bound "
        f"{sum(r['bound_ms'] for r in path):.3f} ms, live bound "
        f"{sum(r['live_bound_ms'] for r in path):.3f} ms, live issue floor "
        f"{sum(r['live_issue_floor_ms'] for r in path):.3f} ms, plain "
        f"{sum(r['plain_ms'] for r in path):.3f} ms")
    log(f"lift_init on the path's {len(init_path)} batches: bit-equal, kernel "
        f"{sum(r['ms'] for r in init_path):.3f} ms summed, bound "
        f"{sum(r['bound_ms'] for r in init_path):.3f} ms, plain "
        f"{sum(r['plain_ms'] for r in init_path):.3f} ms")
    return prod, path, init_path


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
    path, the held batches, ``lift_init``'s held batches)."""
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
        li.lift_init.launches = 0
        openpose.FRAMES.update(native=0, json=0)
        t0 = time.perf_counter()
        stats = process_dataset.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, parsed = fs.filter_sgd.launches, dict(openpose.FRAMES)
        init_launches = li.lift_init.launches

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

        held, init_held = [], []
        for split in RAW_VIDEOS:
            for tb, chunk in raw_batches(feats[split], args.n_partitions):
                kps, masks, noises = (torch.from_numpy(a).to("cuda")
                                      for a in engine._pack(chunk, tb))
                planes, init_row = hold_lift_init(kps, masks, noises, "raw batch")
                init_held.append(init_row)
                held.append(hold_filter(planes + (masks,), len(chunk), "raw batch", fp32,
                                        reps=3))
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
        if init_launches != len(init_held):
            raise AssertionError(f"the raw path launched lift_init {init_launches} times "
                                 f"for {len(init_held)} batches")
        log(f"lift_init on the raw path's {len(init_held)} batches (one launch each): "
            f"bit-equal, kernel {sum(r['ms'] for r in init_held):.3f} ms summed, plain "
            f"{sum(r['plain_ms'] for r in init_held):.3f} ms")

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
    return launches, held, init_held


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


def synthetic_clips_of(rng, n, T):
    """``n`` OpenPose-like (T, 150) clips of ``T`` frames each."""
    kp = rng.uniform(100, 500, size=(n, T, 150)).astype(np.float32)
    kp[:, :, 2::3] = rng.uniform(0.5, 1.0, size=(n, T, 50))
    return list(kp)


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
    the filter_sgd and lift_init launches of the main path and the xyz and
    r6d clips it made."""
    fs.filter_sgd.launches = 0  # counts of the main path start here
    li.lift_init.launches = 0
    xyz, r6d = lift_to_r6d(clips)
    init_launches = li.lift_init.launches  # the main path's lifting: one a batch
    if init_launches != len(engine._plan(clips)):
        raise AssertionError(f"the lifting path launched lift_init {init_launches} times "
                             f"for {len(engine._plan(clips))} batches")
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
        return _enhance_and_check(net, tmp, clips, xyz, X, Xs, sY, mY), init_launches, xyz, r6d


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
# trainer's own step, which runs with cuDNN off, each convolution one
# whole-batch float32 product (ops/conv.py, train/gan.py).  The loss is held relative, the running statistics
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
    return steps / dt


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


def train_phase(xyz, r6d):
    """GAN training of v1 on the card through the port's CLI entry point,
    then inference from its checkpoint and the viz phase on it; returns the
    robust-loss launches of that run, the viz phase's row and the train
    split's windows (X, Y)."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        data_dir = os.path.join(tmp, "data")
        os.makedirs(data_dir)
        io.save_binary(list(r6d), os.path.join(data_dir, "r6d_train"))
        io.save_binary(list(r6d[-N_VAL_CLIPS:]), os.path.join(data_dir, "r6d_val"))
        io.save_binary(xyz, os.path.join(data_dir, "xyz_train"))  # save_results' root
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
        viz = viz_phase(tmp, data_dir, ckpt)

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
    return launches, viz, (X, Y)


# viz phase: GIFs need matplotlib and PIL, imported inside the functions
# that render; where either is missing the CLIs must refuse before any work
VIZ_SEQS = 2



def _port_cli(module, argv, cwd):
    """``python -m <port>.<module> argv`` in ``cwd``: (exit code, stdout,
    stderr)."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-m", f"{train_gan.__package__}.{module}", *argv],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=600)
    return proc.returncode, proc.stdout, proc.stderr


def _gif_info(path):
    """(frame count, duration as PIL reads it back, loop)."""
    from PIL import Image

    with Image.open(path) as im:
        return im.n_frames, im.info.get("duration"), im.info.get("loop")


def _gif_duration(n_frames, frame_rate=2):
    """The duration PIL reads back from a GIF saved with the reference's
    ``len(frames) / frame_rate`` (its unit is ms, stored in 1/100 s)."""
    from PIL import Image

    buf = BytesIO()
    frames = [Image.new("P", (2, 2), i) for i in range(2)]
    frames[0].save(buf, format="GIF", append_images=frames[1:], save_all=True,
                   duration=n_frames / frame_rate, loop=0)
    buf.seek(0)
    with Image.open(buf) as im:
        return im.info.get("duration")


def _check_gifs(paths, lengths, label):
    names = [os.path.basename(p) for p in paths]
    info = [_gif_info(p) for p in paths]
    want = [(T, _gif_duration(T), 0) for T in lengths]
    if names != [f"{i}.gif" for i in range(len(lengths))] or info != want:
        raise AssertionError(f"{label}: GIFs {names} {info}, expected {want}")
    return {"gifs": names, "frames": [i[0] for i in info], "duration": [i[1] for i in info]}


def viz_phase(tmp, data_dir, ckpt):
    """The GIF surfaces on the card, on the train phase's checkpoint
    (``ckpt``, its data in ``data_dir``).  Where matplotlib and PIL import:
    ``inference --seqs_to_viz 2`` and ``viz_gt`` in both modes, the GIFs'
    names, frame counts (T of each clip) and durations checked, and
    ``viz_gt``'s xyz from the card's ``save_results`` held against the CPU's
    at the serving bound (MPJPE 1e-3).  Where either is missing: the
    inference CLI with ``--seqs_to_viz 2`` and ``viz_gt --file_path`` must
    exit nonzero before any work, naming the package, and the inference CLI
    with ``--seqs_to_viz 0`` must still serve.  Returns the phase's row."""
    t0 = time.perf_counter()
    missing = viz_3d.missing()
    have = {name: name not in missing for name in viz_3d.PACKAGES}
    case = "refusal (" + " and ".join(missing) + " missing)" if missing else "render"
    log(f"viz phase: imports {json.dumps(have)} on this machine; case: {case}")
    row = {"packages": have, "case": case}
    argv = ["--checkpoint", ckpt, "--data_dir", data_dir, "--infer_set", "val",
            "--exp_name", "smoke", "--batch_size", str(TRAIN_BATCH), "--device", "cuda"]
    xyz_file = os.path.join(tmp, "viz_xyz.pkl")
    io.save_binary([np.random.RandomState(SEED + 11).uniform(-1, 1, (4, 150)).astype(np.float32)
                    for _ in range(VIZ_SEQS)], xyz_file)
    cwd = os.getcwd()
    if missing:
        for module, cli_argv, wrote in (
                ("inference", argv + ["--seqs_to_viz", str(VIZ_SEQS), "--base_path",
                                      os.path.join(tmp, "viz_refused")],
                 os.path.join(tmp, "viz_refused")),
                ("viz_gt", ["--file_path", xyz_file, "--seqs_to_viz", str(VIZ_SEQS),
                            "--results_dir", os.path.join(tmp, "viz_gt_refused")],
                 os.path.join(tmp, "viz_gt_refused"))):
            rc, out, err = _port_cli(module, cli_argv, tmp)
            said = err.strip().splitlines()[-1] if err.strip() else ""
            log(f"viz phase: {module} --seqs_to_viz {VIZ_SEQS}: exit {rc}; {said}")
            if rc == 0 or not all(m in said for m in missing) or "--seqs_to_viz 0" not in said:
                raise AssertionError(f"{module} did not refuse as it should: exit {rc}, {said}")
            if "test_X.shape" in out or os.path.exists(wrote):
                raise AssertionError(f"{module} did work before refusing: {out[-1000:]}")
            row[f"{module}_refusal"] = {"exit": rc, "message": said}
        os.chdir(tmp)  # save_results writes root.pkl / bone_len.pkl to the cwd
        try:
            err = inference.main(inference.build_parser().parse_args(
                argv + ["--seqs_to_viz", "0", "--base_path", os.path.join(tmp, "viz_zero")]))
        finally:
            os.chdir(cwd)
        xyz = np.asarray(io.load_binary(os.path.join(tmp, "viz_zero", "results_smoke",
                                                     "xyz_val.pkl")))
        log(f"viz phase: inference --seqs_to_viz 0 served xyz {xyz.shape}, L1 {err:.6f}")
        if not (np.isfinite(err) and np.isfinite(xyz).all() and xyz.shape[1:] == (WINDOW_T, 150)):
            raise AssertionError("inference --seqs_to_viz 0 did not serve")
        row["served_with_seqs_to_viz_0"] = {"l1": err, "xyz_shape": list(xyz.shape)}
    else:
        os.chdir(tmp)  # the GIFs, root.pkl and bone_len.pkl go to the cwd
        try:
            err, gifs = inference.run(inference.build_parser().parse_args(
                argv + ["--seqs_to_viz", str(VIZ_SEQS), "--base_path", os.path.join(tmp, "viz")]))
            xyz = io.load_binary(os.path.join(tmp, "viz", "results_smoke", "xyz_val.pkl"))
            row["inference"] = _check_gifs(gifs, [len(c) for c in xyz[:VIZ_SEQS]],
                                           "inference --seqs_to_viz")
            file_gifs = viz_gt.main(viz_gt.build_parser().parse_args(
                ["--file_path", xyz_file, "--seqs_to_viz", str(VIZ_SEQS),
                 "--results_dir", os.path.join(tmp, "viz_gt_file")]))
            row["viz_gt_file"] = _check_gifs(file_gifs, [4] * VIZ_SEQS, "viz_gt --file_path")
            gt = {}
            for dev in ("cuda", "cpu"):
                gifs = viz_gt.main(viz_gt.build_parser().parse_args(
                    ["--data_dir", data_dir, "--infer_set", "val", "--seqs_to_viz", str(VIZ_SEQS),
                     "--exp_name", f"gt_{dev}", "--base_path", tmp, "--device", dev]))
                gt[dev] = io.load_binary(os.path.join(tmp, f"results_gt_{dev}_val", "xyz_val.pkl"))
                row[f"viz_gt_{dev}"] = _check_gifs(gifs, [len(c) for c in gt[dev]], "viz_gt")
        finally:
            os.chdir(cwd)
        m = mpjpe(gt["cuda"], gt["cpu"])
        row["viz_gt_xyz_mpjpe_card_vs_cpu"] = m
        if not m <= MPJPE_BUDGET:
            raise AssertionError(f"viz_gt's xyz on the card is {m} from the CPU's")
    row["seconds"] = time.perf_counter() - t0
    log("viz phase " + json.dumps(row))
    return row


# utils phase: nan_guard, profiling and the build cache's key on the card
def utils_phase(X, Y):
    """``nan_guard.tree_check_finite`` on a trainer's CUDA state after one G
    step (nothing reported; one NaN planted in a gradient, reported by
    name), ``profiling.trace`` around one G step (its Chrome trace must hold
    ``robust_loss_kernel`` and the ``span`` region; a session that loses
    the CUDA record gets a second, and two in a row fail), and
    ``ops/build.library``'s name under a changed toolchain text.  Returns
    the phase's row."""
    t0 = time.perf_counter()
    cfg = gan.GanConfig(loss="RobustLoss", disc_label_smooth=True)
    tr = gan.GanTrainer(cfg, device="cuda")
    xt, yt = (torch.from_numpy(a[:TRAIN_BATCH]).to("cuda") for a in (X, Y))
    tr.g_step(xt, yt)
    grads = {k: p.grad for k, p in tr.generator.named_parameters() if p.grad is not None}
    state = {"generator": tr.generator.state_dict(), "grads": grads,
             "g_opt": tr.g_opt.state_dict()}
    clean = nan_guard.tree_check_finite(state)
    name = sorted(grads)[0]
    grads[name].view(-1)[0] = float("nan")
    planted = nan_guard.tree_check_finite(state)
    row = {"after_g_step": clean, "planted": planted}
    if clean or planted != {f"grads/{name}": 1}:
        raise AssertionError(f"tree_check_finite on the card: {row}")

    region = "chip_smoke_g_step"
    for sessions in (1, 2):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as log_dir:
            with profiling.trace(log_dir):
                with profiling.span(region):
                    tr.g_step(xt, yt)
            (trace_file,) = os.listdir(log_dir)
            with open(os.path.join(log_dir, trace_file)) as f:
                events = json.load(f)["traceEvents"]
        kernel = any(e.get("cat") == "kernel" and "robust_loss_kernel" in e.get("name", "")
                     for e in events)
        annotated = any(e.get("name") == region for e in events)
        if not annotated:
            raise AssertionError(f"profiling.trace holds no {region} region")
        if kernel:
            break
    else:
        raise AssertionError("two profiling.trace sessions in a row lost robust_loss_kernel")
    row["trace"] = {"events": len(events), "robust_loss_kernel": kernel, "span": annotated,
                    "sessions": sessions}

    lib = build.library("robust_loss")
    toolchain = build.platform.toolchain_fingerprint
    build.platform.toolchain_fingerprint = lambda nvcc, host: toolchain(nvcc, host) + "!"
    try:
        other = build.library("robust_loss")
    finally:
        build.platform.toolchain_fingerprint = toolchain
    row["library"] = {"built": lib.name, "exists": lib.exists(),
                      "under_another_toolchain": other.name,
                      "toolchain": toolchain(build._tool("nvcc"), build._tool("g++")).splitlines()}
    if other == lib or not lib.exists():
        raise AssertionError(f"the build cache's key ignores the toolchain: {row['library']}")
    row["seconds"] = time.perf_counter() - t0
    log("utils phase " + json.dumps(row))
    return row

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
        "--batch_size", str(TRAIN_BATCH), "--device", "cuda", "--seqs_to_viz", "0",
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
               "--refcfg_nonbidir_epochs", "1", "--anomaly_controls", "--device", "cuda"]
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


def check_replay_report(report, seqs_to_viz):
    """Complete, with finite L1 on every split of both configurations and of
    each K, accuracies in [0, 1] (the unidirectional reference config's too,
    with its note), and ``seqs_to_viz`` GIFs of each test split or none."""
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
    for name, entry in (*report["configs"].items(), *report["finger_trend"].items()):
        gifs = entry["inference"]["gifs"]
        want = {"test": VIZ_SEQS} if seqs_to_viz else {}
        if {k: len(v) for k, v in gifs.items()} != want or not all(
                os.path.exists(p) for v in gifs.values() for p in v):
            bad.append(f"{name} GIFs {gifs}")
    cls = report["classifier"]
    accs = {key: cls[key]["best_val_acc"] for key in (
        "ground_truth_r6d", "enhanced_r6d", "enhanced_r6d_reference_config",
        "enhanced_r6d_reference_config_nonbidir", "text_mlp")}
    accs.update({f"control {key}": v["best_val_acc"]
                 for key, v in cls["anomaly_controls"].items() if key != "explanation"})
    if len(accs) != 9 or not all(0.0 <= a <= 1.0 for a in accs.values()):
        bad.append(f"accuracies {accs}")
    uni = cls["enhanced_r6d_reference_config_nonbidir"]
    if (uni["hidden"], uni["layers"], uni["bidir"]) != (1024, 10, False) \
            or "unidirectional" not in cls.get("reference_config_note", ""):
        bad.append(f"unidirectional reference config {uni}")
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

    missing = viz_3d.missing()
    viz_args = ["--seqs_to_viz", "0"] if missing else []
    log(f"replay: GIF packages missing here: {json.dumps(missing)}: "
        + ("the replay renders its GIFs" if not viz_args else
           "--seqs_to_viz 0, the replay renders no GIF"))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_replay_") as tmp:
        work, out = os.path.join(tmp, "work"), os.path.join(tmp, "replay.json")
        argv = REPLAY_ARGS + viz_args + ["--work_dir", work, "--out", out]
        args = article_replay.build_parser().parse_args(argv)
        cwd = os.getcwd()
        os.chdir(tmp)  # the CLIs write root.pkl, bone_len.pkl and GT_predY.csv here
        rl.robust_loss_and_dx = recording
        try:
            fs.filter_sgd.launches = 0  # counts of the replay start here
            rl.robust_lossfun.launches = 0
            li.lift_init.launches = 0
            t0 = time.perf_counter()
            report = article_replay.main(args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {"filter_sgd": fs.filter_sgd.launches,
                        "robust_loss": rl.robust_lossfun.launches,
                        "lift_init": li.lift_init.launches}
        finally:
            rl.robust_loss_and_dx = launch
            os.chdir(cwd)
        log(f"replay: {wall:.1f} s, launches {launches}, robust_loss shapes {sorted(shapes)}")
        if not all(launches.values()):
            raise AssertionError(f"a kernel of the replay path never launched: {launches}")
        accs = check_replay_report(report, args.seqs_to_viz)

        # a --resume runs no stage again, the unidirectional reference config
        # included, and keeps every entry
        stages = {k: getattr(article_replay, k) for k in (
            "stage_train", "stage_classifier", "stage_raw_smoke", "stage_mlp_classifier")}

        def ran_again(*a, **k):
            raise AssertionError("a --resume of the replay ran a stage again")

        os.chdir(tmp)
        try:
            for k in stages:
                setattr(article_replay, k, ran_again)
            t0 = time.perf_counter()
            resumed = article_replay.main(article_replay.build_parser().parse_args(
                argv + ["--resume"]))
            resume_s = time.perf_counter() - t0
        finally:
            for k, v in stages.items():
                setattr(article_replay, k, v)
            os.chdir(cwd)
        for key in ("classifier", "configs", "finger_trend"):
            if resumed[key] != report[key]:
                raise AssertionError(f"--resume changed the replay's {key}")
        log(f"replay --resume: every stage skipped in {resume_s:.1f} s, the unidirectional "
            f"reference config {json.dumps(report['classifier']['enhanced_r6d_reference_config_nonbidir'])}")

        t0 = time.perf_counter()
        fixture_err, fixture_worst = hold_fixture(os.path.join(work, "video_data"), tmp,
                                                  report["fixture"])
        log(f"replay fixture card vs CPU: max |r6d| {fixture_err['r6d_']:.3e}, max |xyz| "
            f"{fixture_err['xyz_']:.3e}, everything else equal "
            f"({time.perf_counter() - t0:.1f} s); worst entries {json.dumps(fixture_worst)}")
        raw_dir = os.path.join(work, "raw_processed")
        filter_rows, init_rows = [], []
        for split in ("train", "val", "test"):
            feats = io.load_binary(os.path.join(raw_dir, f"xy_{split}.pkl"))
            for tb, chunk in raw_batches(feats, REPLAY_RAW_PARTITIONS):
                kps, masks, noises = (torch.from_numpy(a).to("cuda")
                                      for a in engine._pack(chunk, tb))
                planes, init_row = hold_lift_init(kps, masks, noises, "replay raw batch")
                init_rows.append(init_row)
                filter_rows.append(hold_filter(
                    planes + (masks,), len(chunk), "replay raw batch", fp32, reps=20,
                    n_cycles=REPLAY_RAW_CYCLES))
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
        if launches["lift_init"] != len(init_rows):
            raise AssertionError(f"the replay launched lift_init {launches['lift_init']} times "
                                 f"for its {len(init_rows)} raw-smoke batches")

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
        "reference_config_note": report["classifier"]["reference_config_note"],
        "resume_s": resume_s,
        "gifs": {k: e["inference"]["gifs"] for k, e in report["configs"].items()},
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
        "lift_init": {"launches_replay": launches["lift_init"],
                      "replay_held": [{k: r[k] for k in ("B", "T", "launches", "ms",
                                                         "plain_ms", "bound_ms", "bit_equal")}
                                      for r in init_rows]},
    }


# featurizer phase: the towers at the widths the JAX routes default to,
# seeded random weights written as local snapshots (the card's machine has
# no transformers, safetensors or cv2)
FEAT_REL_ATOL = FWD_REL_ATOL  # card vs CPU, relative to the largest output
MINILM = dict(hidden_size=384, num_layers=6, num_heads=12, intermediate_size=1536)
BERT_BASE = dict(hidden_size=768, num_layers=12, num_heads=12, intermediate_size=3072)
BERT_VOCAB = 30522
N_SENTENCES = 16  # the last one runs past 512 tokens (BERTword truncates it)
FEAT_FRAMES = (24, 16)  # two clips of How2Sign's 1280x720 frames
FEAT_BATCH = 256
RATE_FRAMES = 2048  # one clip through obtain_feats_crops_resnet: 4096 crops
H2S_FRAMES = 10e6  # How2Sign's frames, about (PERF.md section 1)
_WORDS = ("sign language hand hands arm arms the a an of to and in is it that you we they "
          "i'm don't it's we'll can't how2sign asl signer video camera left right finger "
          "fingers move moves moving point points up down over under café naïve résumé "
          "3 12 2023 1,000 3.14 first second next then now today yesterday").split()


def feat_sentences(rng):
    """How2Sign-like sentences from a seed: 8 to 40 words with digits,
    accents, contractions and punctuation; the last one over 512 tokens."""
    out = []
    for i in range(N_SENTENCES):
        n = 700 if i == N_SENTENCES - 1 else rng.randint(8, 41)
        words = [_WORDS[j] for j in rng.randint(0, len(_WORDS), n)]
        words[0] = words[0].capitalize()
        out.append(" ".join(words) + rng.choice([".", "?", "!", "..."]))
    return out


def feat_frames(rng, root):
    """Seeded 1280x720 clips and one OpenPose JSON a frame with both hands'
    keypoints near a drifting palm center (every fifth frame has no JSON:
    the fallback center).  Returns (clips (T, 3, 720, 1280) uint8, ids)."""
    clips, ids = [], []
    for c, T in enumerate(FEAT_FRAMES):
        sid = f"feat{c:07d}-1-rgb_front"
        os.makedirs(os.path.join(root, sid))
        clips.append(rng.randint(0, 256, size=(T, 3, 720, 1280), dtype=np.uint8))
        for t in range(T):
            if t % 5 == 4:
                continue
            people = {}
            for hand, (x, y) in (("right", (300 + 20 * t, 500)), ("left", (1000, 80 + 9 * t))):
                kp = np.zeros(63)
                kp[0::3] = x + rng.uniform(-15, 15, 21)
                kp[1::3] = y + rng.uniform(-15, 15, 21)
                kp[2::3] = 0.9
                people[f"hand_{hand}_keypoints_2d"] = kp.tolist()
            with open(os.path.join(root, sid, f"{sid}_{t:012d}_keypoints.json"), "w") as f:
                json.dump({"people": [people]}, f)
        ids.append(sid)
    return clips, ids


def hold_feat(label, card, cpu):
    """The card's output within FEAT_REL_ATOL of the CPU's largest value."""
    card, cpu = (np.concatenate([np.asarray(a).reshape(-1) for a in x])
                 for x in (card, cpu))
    err, scale = float(np.abs(card - cpu).max()), float(np.abs(cpu).max())
    row = {"max_abs_err": err, "max_abs_out": scale, "bound": FEAT_REL_ATOL * scale,
           "rule": "relative"}
    log(f"{label}: card vs CPU max abs {err:.3e} (max |out| {scale:.4g}, bound "
        f"{row['bound']:.3e})")
    return row


def hold_resnet64(crops, pth, card, cpu):
    """ResNet-50's features against a float64 CPU evaluation of the same
    normalized crops: the card's error at most twice the CPU's float32 one."""
    model = resnet_lib.load_resnet50(pth, device="cpu").double()
    mean = torch.as_tensor(video.IMAGENET_MEAN)[:, None, None]
    std = torch.as_tensor(video.IMAGENET_STD)[:, None, None]
    ref = []
    with torch.inference_mode():
        for c in crops:
            hands = [model(((torch.from_numpy(np.ascontiguousarray(c[..., j])).float() - mean)
                            / std).double()).numpy() for j in (0, 1)]
            ref.append(np.hstack(hands))
    err_card = max(float(np.abs(a - r).max()) for a, r in zip(card, ref))
    err_cpu = max(float(np.abs(a - r).max()) for a, r in zip(cpu, ref))
    log(f"resnet features vs float64: card {err_card:.3e}, CPU {err_cpu:.3e} "
        f"(ratio {err_card / err_cpu:.3f}, bound 2)")
    return {"rule": "float64", "card_err_f64": err_card, "cpu_err_f64": err_cpu,
            "ok": err_card <= 2 * err_cpu}


def _timed(fn):
    """(fn(), its wall seconds to a synchronized end)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def feat_rates(snaps, pth, bert_tokens):
    """Tower forwards on the card at float32 (cuda events, ms per batch) and
    the rates they give; ResNet-50 also through its route on one clip."""
    from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data.tokenizers import (
        CLIPBPETokenizer,
    )

    gen = torch.Generator().manual_seed(SEED)
    rates = {}
    with torch.inference_mode(), infer.conv_matmul_precision("float32"):
        for name, snap, B, T in (("minilm", snaps["BERTsentence"], FEAT_BATCH, bert_tokens),
                                 ("bert_base_512", snaps["BERTword"], 64, 512)):
            model = text_encoders.load_bert(snap, "cuda")
            ids = torch.randint(1000, BERT_VOCAB, (B, T), generator=gen).cuda()
            mask = torch.ones_like(ids)
            ms = cuda_ms(lambda: model(ids, mask, output_hidden_states=True), 3)
            rates[name] = {"B": B, "T": T, "ms": ms, "sentences_per_s": B / ms * 1e3}
        tok = CLIPBPETokenizer.from_dir(snaps["clip"])
        model = text_encoders.load_clip_text(snaps["clip"], tok.eos_token_id, "cuda")
        ids = torch.randint(0, 49406, (FEAT_BATCH, 77), generator=gen).cuda()
        ids[:, 40] = tok.eos_token_id
        ms = cuda_ms(lambda: model(ids), 3)
        rates["clip_text"] = {"B": FEAT_BATCH, "T": 77, "ms": ms,
                              "sentences_per_s": FEAT_BATCH / ms * 1e3}
        model = clip_vision.load_clip_vision(snaps["clip"], "cuda")
        crops = torch.randint(0, 256, (FEAT_BATCH, 3, 120, 120), generator=gen).cuda()
        px = clip_vision.clip_preprocess(crops, 224)
        ms = cuda_ms(lambda: model(px), 3)
        ms_pre = cuda_ms(lambda: model(clip_vision.clip_preprocess(crops, 224)), 3)
        rates["clip_vision"] = {"B": FEAT_BATCH, "ms": ms, "ms_with_preprocess": ms_pre,
                                "crops_per_s": FEAT_BATCH / ms_pre * 1e3}
        model = resnet_lib.load_resnet50(pth, device="cuda")
        x = torch.randn(FEAT_BATCH, 3, 120, 120, generator=gen).cuda()
        ms = cuda_ms(lambda: model(x), 3)
        rates["resnet50"] = {"B": FEAT_BATCH, "ms": ms, "crops_per_s": FEAT_BATCH / ms * 1e3}
    clip = [np.random.RandomState(SEED).randint(0, 256, (RATE_FRAMES, 3, 120, 120, 2),
                                                dtype=np.uint8)]
    video.obtain_feats_crops_resnet(clip, pth, device="cuda")  # cuDNN's first choice
    _, wall = _timed(lambda: video.obtain_feats_crops_resnet(clip, pth, device="cuda"))
    route = 2 * RATE_FRAMES / wall
    rates["resnet50"].update(route_crops_per_s=route, route_wall_s=wall,
                             how2sign_hours=2 * H2S_FRAMES / route / 3600)
    for name, r in rates.items():
        log(f"rate {name}: " + ", ".join(f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                                         for k, v in r.items()))
    return rates


def featurizer_phase():
    """The featurizers on the card at full width with seeded snapshots: the
    three text methods through ``data/text.obtain_embeddings``, the hand crops
    through ``obtain_cropped_clips`` and their ResNet-50 and CLIP features,
    ``process_dataset.main --vid_feats`` over a crops pickle; every output
    against the port's CPU path on the same weights (2^-15 of the largest
    value; ResNet-50 against float64 where cuDNN breaks that), TF32 shown
    to miss the bound; rates.  Neither kernel lies on this path: its counts
    are read to show so."""
    t_phase = time.perf_counter()
    rng = np.random.RandomState(SEED + 8)
    rows = {}
    fs.filter_sgd.launches = 0  # counts of the featurizer path start here
    rl.robust_lossfun.launches = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_feat_") as tmp:
        t0 = time.perf_counter()
        sentences = feat_sentences(rng)
        ids = [f"sent{i:07d}-1-rgb_front" for i in range(N_SENTENCES)]
        text_path = os.path.join(tmp, "train.text.id.en")
        with open(text_path, "w") as f:
            f.write("".join(f"{i} {s}\n" for i, s in zip(ids, sentences)))
        minilm = synthetic.write_bert_snapshot(os.path.join(tmp, "minilm"), sentences,
                                               vocab_size=BERT_VOCAB, seed=SEED, **MINILM)
        snaps = {"BERTsentence": minilm,
                 "BERTword": synthetic.write_bert_snapshot(
                     os.path.join(tmp, "bert"), sentences, vocab_size=BERT_VOCAB,
                     seed=SEED + 1, **BERT_BASE),
                 "clip": synthetic.write_clip_snapshot(os.path.join(tmp, "clip"), sentences,
                                                       n_merges=2000, seed=SEED + 2)}
        pth = synthetic.write_resnet50_weights(os.path.join(tmp, "resnet50.pth"), seed=SEED + 3)
        log(f"featurizer snapshots written in {time.perf_counter() - t0:.1f} s")

        for method, snap in snaps.items():
            card, wall = _timed(lambda: text.obtain_embeddings(
                text_path, ids, method=method, weights_path=snap, device="cuda"))
            cpu = text.obtain_embeddings(text_path, ids, method=method, weights_path=snap,
                                         device="cpu")
            if card.shape != cpu.shape or not np.isfinite(card).all():
                raise AssertionError(f"{method}: card {card.shape}, CPU {cpu.shape}")
            rows[method] = hold_feat(f"{method} {card.shape}", card, cpu) | {
                "shape": list(card.shape), "route_wall_s": wall}

        # TF32 on bert-base's last-four sum must miss the bound
        tok = tokenizers.WordPieceTokenizer.from_dir(snaps["BERTword"])
        enc = tok(sentences[:4], padding="max_length", max_length=512)
        model = text_encoders.load_bert(snaps["BERTword"], "cuda")
        ids_t, mask_t = (torch.from_numpy(enc[k]).cuda() for k in ("input_ids", "attention_mask"))
        with torch.inference_mode(), infer.conv_matmul_precision("tensorfloat32"):
            tf32 = sum(model(ids_t, mask_t, output_hidden_states=True)[1][-4:]).cpu().numpy()
        cpu = text.obtain_embeddings(text_path, ids[:4], method="BERTword",
                                     weights_path=snaps["BERTword"], device="cpu")
        row = hold_feat("BERTword TF32", tf32, cpu)
        if row["max_abs_err"] <= row["bound"]:
            raise AssertionError(f"TF32 bert-base within the float32 bound: {row}")
        rows["BERTword_tf32"] = row

        json_root = os.path.join(tmp, "json")
        frames, clip_ids = feat_frames(rng, json_root)
        crops = video.obtain_cropped_clips(frames, json_root, clip_ids)
        if [c.shape for c in crops] != [(T, 3, 120, 120, 2) for T in FEAT_FRAMES]:
            raise AssertionError(f"crops {[c.shape for c in crops]}")
        resnet_card, wall = _timed(lambda: video.obtain_feats_crops_resnet(
            crops, pth, device="cuda"))
        cpu = video.obtain_feats_crops_resnet(crops, pth, device="cpu")
        row = hold_feat("resnet50 features", resnet_card, cpu) | {
            "shape": [list(c.shape) for c in resnet_card], "route_wall_s": wall}
        if row["max_abs_err"] > row["bound"]:
            row |= hold_resnet64(crops, pth, resnet_card, cpu)
        rows["resnet50"] = row
        card, wall = _timed(lambda: video.obtain_feats_crops_clip(crops, snaps["clip"],
                                                                  device="cuda"))
        cpu = video.obtain_feats_crops_clip(crops, snaps["clip"], device="cpu")
        rows["clip_image"] = hold_feat("clip image features", card, cpu) | {
            "shape": [list(c.shape) for c in card], "route_wall_s": wall}

        # the CLI: --vid_feats over a crops pickle (obtain_vid_feats; no cv2 here)
        tree = os.path.join(tmp, "tree")
        synthetic.make_openpose_tree(tree, n_videos=2, utts_per_video=1, frames=4, seed=SEED,
                                     splits=("train",))
        data_dir = os.path.join(tmp, "data")
        os.makedirs(data_dir)
        io.save_binary(crops, os.path.join(data_dir, "train_vid_crops.pkl"))
        args = process_dataset.build_parser().parse_args(
            ["--dataset_path", tree, "--data_dir", data_dir, "--vid_feats", "--resnet_weights",
             pth, "--workers", "1", "--device", "cuda"])
        t0 = time.perf_counter()
        process_dataset.main(process_dataset.resolve_templates(args))
        cli_s = time.perf_counter() - t0
        got = io.load_binary(os.path.join(data_dir, "train_vid_feats.pkl"))
        if [g.shape for g in got] != [(T, 2000) for T in FEAT_FRAMES] or any(
                g.dtype != np.float32 for g in got):
            raise AssertionError(f"process_dataset --vid_feats wrote {[g.shape for g in got]}")
        rows["cli_vid_feats"] = hold_feat("process_dataset --vid_feats vs the route on the card",
                                          got, resnet_card) | {"wall_s": cli_s}
        launches = {"filter_sgd": fs.filter_sgd.launches,
                    "robust_loss": rl.robust_lossfun.launches}
        # MiniLM's rate at the padded length of the sentences under 512 tokens
        minilm_T = tokenizers.WordPieceTokenizer.from_dir(minilm)(sentences[:-1])
        rates = feat_rates(snaps, pth, minilm_T["input_ids"].shape[1])

    failed = [k for k, r in rows.items() if k != "BERTword_tf32"
              and not (r.get("ok") if r["rule"] == "float64" else r["max_abs_err"] <= r["bound"])]
    wall = time.perf_counter() - t_phase
    print(json.dumps({"featurizers": {"held": rows, "rates": rates, "launches": launches,
                                      "wall_s": wall}}), flush=True)
    if failed:
        raise AssertionError(f"featurizer outputs over their bounds: {failed}")
    log(f"featurizer phase: {wall:.1f} s; kernel launches on its path {launches}")
    return launches


# lifting-alternatives phase: the demo CLI (the single-clip v2 API) card vs CPU
DEMO_FRAMES = 1920  # the serving clips' longest


def demo_sequence(rng, T):
    """A seeded OpenPose-like (T, 150) sequence, as the demo's synthetic one."""
    X = rng.uniform(100, 500, size=(T, 150)).astype(np.float32)
    X[:, 2::3] = rng.uniform(0.5, 1.0, size=(T, 50))
    return X


def lift_alt_phase():
    """The demo CLI on the card against the demo on the CPU (its synthetic
    64 frames and a seeded DEMO_FRAMES-frame .npy), at the lifting
    tolerances, ``filter_sgd``'s count at 0 just before.  Returns the
    phase's summary."""
    fs.filter_sgd.launches = 0  # counts of this path start here
    demo_rows = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_demo_") as tmp:
        seq = os.path.join(tmp, "seq.npy")
        np.save(seq, demo_sequence(np.random.RandomState(SEED + 7), DEMO_FRAMES))
        for label, extra in (("synthetic 64 frames", []),
                             (f"seeded {DEMO_FRAMES} frames", ["--input", seq])):
            out = {}
            for device in ("cuda", "cpu"):
                args = demo.build_parser().parse_args(
                    extra + ["--out_dir", os.path.join(tmp, device), "--device", device])
                before = fs.filter_sgd.launches
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out[device] = demo.main(args)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                if device == "cuda":
                    launches, card_s = fs.filter_sgd.launches - before, wall
            dxy = max(float(np.abs(a - b).max()) for a, b in zip(out["cuda"][:2], out["cpu"][:2]))
            dz = float(np.abs(out["cuda"][2] - out["cpu"][2]).max())
            row = {"sequence": label, "launches": launches, "card_s": card_s, "cpu_s": wall,
                   "max_abs_xy": dxy, "max_abs_z": dz}
            log("demo card vs cpu " + json.dumps(row))
            if not (launches > 0 and dxy <= LIFT_ATOL and dz <= LIFT_Z_ATOL):
                raise AssertionError(f"the demo on the card disagrees with the CPU: {row}")
            demo_rows.append(row)
    return {"launches_lifting_alt": fs.filter_sgd.launches, "lifting_alt": {"demo": demo_rows}}


# options phase: bf16 serving and training, fused_d, grad flow, float64 clips
BF16_FWD_MAX, BF16_FWD_MEAN = 0.15, 0.02  # tests/test_inference_lib.py:55-63
BF16_LOSS_REL = 0.05  # tests/test_train_extensions.py:62
# a bf16 step's gradient, each tensor against the float32 step's, in norm
# relative to it (a zeroed gradient is 1 away; tests/test_torch_options.py)
BF16_GRAD_REL = 0.75
FUSED_GRAD_REL = 2.0**-6  # fused_d's gradient against the sequential step's
BF16_CHECK_WINDOWS = 512
OPT_EPOCHS = 2  # with --epochs_train_disc 1: epoch 0 trains G and validates, 1 D
LEGACY_REF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                          "load_data_float64_ref.npz")
# the port's load_data on float64 clips against the JAX package's legacy
# route (a CPU-side reference: tests/test_torch_options.py writes it; the
# two are bit-equal there); here numpy may sum in another order
LEGACY_ATOL = 2.0**-20


def bf16_forward(model, cond, X, F):
    """A generator's bf16 forward against its float32 one on the first
    BF16_CHECK_WINDOWS windows (the JAX package's bars), and both timed at
    B=2048, T=192 (TF32 too, for scale)."""
    kw = _cond_kwargs(cond)
    net = registry.build_generator(model, 36, 252, seed=SEED, device="cuda", **kw)
    n = min(BF16_CHECK_WINDOWS, len(X))
    f = None if F is None else F[:n]
    f32, _ = infer.run_inference(net, X[:n], test_feats=f, batch_size=128, num_samples=n,
                                 device="cuda")
    b16, _ = infer.run_inference(net, X[:n], test_feats=f, batch_size=128, num_samples=n,
                                 device="cuda", bf16=True)
    err = np.abs(b16 - f32)
    idx = torch.arange(FWD_BATCH, device="cuda") % len(X)
    xb = torch.from_numpy(X).to("cuda")[idx].transpose(1, 2)
    fb = None if F is None else torch.from_numpy(F).to("cuda")[idx]
    net16 = copy.deepcopy(net).to(torch.bfloat16)
    xb16, fb16 = xb.to(torch.bfloat16), None if fb is None else fb.to(torch.bfloat16)
    ms = {}
    with torch.no_grad():
        for precision in ("float32", "tensorfloat32"):
            with infer.conv_matmul_precision(precision):
                ms[precision] = cuda_ms(lambda: net(xb, fb), reps=5)
        ms["bfloat16"] = cuda_ms(lambda: net16(xb16, fb16), reps=5)
    del xb, fb, xb16, fb16, net16
    row = {"model": model, "conditioning": cond, "windows": n,
           "bf16_vs_float32_max": float(err.max()), "bf16_vs_float32_mean": float(err.mean()),
           "forward_ms": ms,
           "frames_per_s": {k: FWD_BATCH * WINDOW_T / v * 1e3 for k, v in ms.items()}}
    log("bf16 forward " + json.dumps(row))
    if not (err.max() < BF16_FWD_MAX and err.mean() < BF16_FWD_MEAN):
        raise AssertionError(f"{model}: the bf16 forward misses the JAX package's bars: {row}")
    return row


def hold_robust_residual(x, alpha, c):
    """The robust-loss kernel against its plain version on a residual the
    training run produced (no profiler here: the kernel is timed at the
    script's start); columns at alpha = 2 +- 1 ulp are reported, as in
    ``hold_robust``."""
    loss, dx = rl.robust_loss_and_dx(x, alpha, c)
    xg = x.clone().requires_grad_(True)
    want = rl.robust_lossfun_plain(xg, alpha, c)
    (want_dx,) = torch.autograd.grad(want.sum(), xg)
    want = want.detach()
    a = alpha.reshape(-1)
    two = torch.full_like(a, 2.0)
    ulp = ((a == torch.nextafter(two, two + 1)) | (a == torch.nextafter(two, two - 1)))
    e_loss, x_loss = _excess(loss, want, ROBUST_LOSS_TOL, ~ulp)
    e_dx, x_dx = _excess(dx, want_dx, ROBUST_DX_TOL, ~ulp)
    row = {"N": x.shape[0], "D": x.shape[1], "max_abs_err": max(e_loss, e_dx),
           "max_err_over_tol": max(x_loss, x_dx), "ulp_columns": int(ulp.sum()),
           "wrapper_ms": cuda_ms(lambda: rl.robust_loss_and_dx(x, alpha, c), reps=20)}
    log("kernel robust_loss on the bf16 run's residual " + json.dumps(row))
    if not (x_loss <= 1.0 and x_dx <= 1.0):
        raise AssertionError(f"robust_loss disagrees with its plain version: {row}")
    return row


def bf16_train(tmp, data_dir, data):
    """``train_gan.main --bf16 --log_grad_flow 1`` for v1 arm2wh at B=128,
    OPT_EPOCHS epochs, ``robust_loss``'s count at 0 just before; every
    epoch watched and the master weights, statistics and Adam state held
    float32; the grad-flow events read back; a residual the run gave the
    kernel held against its plain version; then ``inference.main`` from its
    checkpoint with and without ``--bf16``.  Returns (launches, summary)."""
    args = train_gan.build_parser().parse_args([
        "--base_path", tmp, "--data_dir", data_dir,
        "--model_path", os.path.join(tmp, "models"), "--exp_name", "bf16",
        "--num_epochs", str(OPT_EPOCHS), "--epochs_train_disc", "1",
        "--batch_size", str(TRAIN_BATCH), "--loss", "RobustLoss", "--disc_label_smooth",
        "--bf16", "--log_grad_flow", "1", "--device", "cuda",
    ])
    hook, seen = epoch_watch(gan.GanConfig(loss="RobustLoss", compute_dtype="bfloat16"))

    def watch(epoch, kind, trainer, losses):
        hook(epoch, kind, trainer, losses)
        tensors = [*trainer.generator.state_dict().values(),
                   *trainer.discriminator.state_dict().values(),
                   *(s for opt in (trainer.g_opt, trainer.d_opt)
                     for st in opt.state.values() for s in st.values())]
        odd = {str(t.dtype) for t in tensors
               if t.is_floating_point() and t.dtype != torch.float32}
        if trainer.dtype != torch.bfloat16 or odd:
            raise AssertionError(f"epoch {epoch}: compute {trainer.dtype}, master dtypes {odd}")

    captured = []
    launch = rl.robust_loss_and_dx

    def recording(x, alpha, scale):
        if not captured:
            captured.append((x.detach().clone(), alpha.detach().clone(), scale.detach().clone()))
        return launch(x, alpha, scale)

    rl.robust_loss_and_dx = recording
    try:
        rl.robust_lossfun.launches = 0  # counts of this path start here
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        best = train_gan.main(args, epoch_hook=watch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = rl.robust_lossfun.launches  # end of this path
    finally:
        rl.robust_loss_and_dx = launch
    # the G and val batches, and the G loss of each epoch's grad flow
    steps = (len(data["train_X"]) // TRAIN_BATCH + len(data["val_X"]) // (TRAIN_BATCH // 2)
             + OPT_EPOCHS)
    log(f"train_gan.main --bf16 --log_grad_flow 1: {OPT_EPOCHS} epochs in {wall:.3f} s, "
        f"best val {best:.6f}, robust_loss launches {launches}; "
        + "; ".join(f"epoch {e} {k} {json.dumps(l)}" for e, k, l in seen))
    if [k for _, k, _ in seen] != ["g", "d"] or launches != steps:
        raise AssertionError(f"bf16 training: schedule {seen}, robust_loss launched "
                             f"{launches} times for {steps} G, val and grad-flow losses")
    with open(os.path.join(args.model_path, "metrics_bf16.jsonl")) as f:
        flows = [e for e in map(json.loads, f) if e.get("event") == "grad_flow"]
    names = [n for n, _ in registry.build_generator("v1", 36, 252, device="cpu")
             .named_parameters()]
    if ([e["epoch"] for e in flows] != list(range(OPT_EPOCHS))
            or any(not all(np.isfinite(e[n]) for n in names) for e in flows)):
        raise AssertionError(f"grad-flow events: {flows}")
    log(f"grad-flow events at epochs {[e['epoch'] for e in flows]}, {len(names)} tensors "
        f"each, mean |g| over {min(min(e[n] for n in names) for e in flows):.3e} .. "
        f"{max(max(e[n] for n in names) for e in flows):.3e}")
    held = hold_robust_residual(*captured[0])

    xyz = {}
    cwd = os.getcwd()
    os.chdir(tmp)  # save_results writes root.pkl / bone_len.pkl to the cwd
    try:
        for bf16 in (False, True):
            iargs = inference.build_parser().parse_args([
                "--checkpoint", os.path.join(args.model_path, "lastCheckpoint_bf16.pth"),
                "--base_path", tmp, "--data_dir", data_dir, "--infer_set", "val",
                "--exp_name", "bf16", "--batch_size", str(TRAIN_BATCH), "--device", "cuda",
                "--seqs_to_viz", "0",
            ] + (["--bf16"] if bf16 else []))
            inference.main(iargs)
            xyz[bf16] = np.asarray(io.load_binary(os.path.join(tmp, "results_bf16",
                                                               "xyz_val.pkl")))
    finally:
        os.chdir(cwd)
    if not all(np.isfinite(a).all() for a in xyz.values()):
        raise AssertionError("inference --bf16 gave non-finite xyz")
    e2e = mpjpe(xyz[True], xyz[False])
    log(f"inference.main --bf16 vs float32 from the bf16-trained checkpoint: end-to-end "
        f"xyz MPJPE {e2e:.3e} over {len(xyz[True])} windows (no bound; budget "
        f"{MPJPE_BUDGET} at float32)")
    return launches, {"train_s": wall, "launches": launches, "grad_flow_events": len(flows),
                      "residual_held": held, "mpjpe_bf16_vs_float32": e2e}


def first_moments(tr, kind):
    """Adam's first moment after one step, (1 - b1) g, per parameter the
    step reached: the step's gradient, on the trainer's names."""
    module = tr.generator if kind == "g" else tr.discriminator
    opt = tr.g_opt if kind == "g" else tr.d_opt
    return {k: opt.state[q]["exp_avg"] for k, q in module.named_parameters() if q in opt.state}


def worst_grad_rel(got, want):
    """The largest distance of a tensor of ``got`` from ``want``'s, in norm
    relative to it."""
    return max(float((v - want[k]).norm() / want[k].norm()) for k, v in got.items())


def step_pairs(X, Y):
    """One G and one D step at bf16 against float32 from the same seeded
    state (dropout 0): G's loss within BF16_LOSS_REL (the JAX package's
    bar), D's reported; each tensor's gradient within BF16_GRAD_REL of the
    float32 step's.  One D step fused against sequential: the loss within
    STEP_LOSS_RTOL, the running statistics within STEP_ATOL, each gradient
    within FUSED_GRAD_REL, the parameters within 2 lr + STEP_ATOL and their
    share beyond STEP_ATOL reported."""
    xb = torch.from_numpy(X[:TRAIN_BATCH]).to("cuda")
    yb = torch.from_numpy(Y[:TRAIN_BATCH]).to("cuda")
    cfg = gan.GanConfig(loss="RobustLoss", disc_label_smooth=True, dropout_rate=0.0)
    loss, moments = {}, {}
    for dtype in ("float32", "bfloat16"):
        for kind in ("g", "d"):
            tr = gan.GanTrainer(dataclasses.replace(cfg, compute_dtype=dtype), device="cuda")
            loss[f"{kind} {dtype}"] = float(tr._step(kind)(xb, yb))
            moments[f"{kind} {dtype}"] = first_moments(tr, kind)
    rel = {k: abs(loss[f"{k} bfloat16"] - loss[f"{k} float32"]) / max(abs(loss[f"{k} float32"]), 1.0)
           for k in ("g", "d")}
    grad_rel = {k: worst_grad_rel(moments[f"{k} bfloat16"], moments[f"{k} float32"])
                for k in ("g", "d")}
    seq = gan.GanTrainer(cfg, device="cuda")
    fused = gan.GanTrainer(dataclasses.replace(cfg, fused_d=True), device="cuda")
    ls, lf = float(seq.d_step(xb, yb)), float(fused.d_step(xb, yb))
    a, b = seq.discriminator.state_dict(), fused.discriminator.state_dict()
    stat = max(float((a[k] - b[k]).abs().max()) for k in a if "running" in k)
    params = [(a[k] - b[k]).abs() for k in a if "running" not in k and "num_batches" not in k]
    row = {"losses": loss, "bf16_rel": rel, "bf16_grad_rel": grad_rel,
           "fused_d": {"loss_seq": ls, "loss_fused": lf,
                       "loss_rel": abs(lf - ls) / max(abs(ls), 1e-30), "running_stat_err": stat,
                       "grad_rel": worst_grad_rel(first_moments(fused, "d"),
                                                  first_moments(seq, "d")),
                       "param_err": max(float(p.max()) for p in params),
                       "param_share_beyond_atol": sum(int((p > STEP_ATOL).sum()) for p in params)
                       / sum(p.numel() for p in params),
                       "num_batches_tracked": int(b["convs.3.num_batches_tracked"])}}
    log("bf16 and fused_d steps " + json.dumps(row))
    f = row["fused_d"]
    if not (rel["g"] <= BF16_LOSS_REL and max(grad_rel.values()) <= BF16_GRAD_REL
            and f["loss_rel"] <= STEP_LOSS_RTOL and stat <= STEP_ATOL
            and f["grad_rel"] <= FUSED_GRAD_REL
            and f["param_err"] <= 2 * STEP_LR + STEP_ATOL
            and f["num_batches_tracked"] == 2):
        raise AssertionError(f"bf16 or fused_d step off: {row}")
    return row


def legacy_load_data(tmp):
    """The port's load_data on float64 clips (data/synthetic.write_float64_r6d)
    against the JAX legacy route's arrays in LEGACY_REF."""
    d = synthetic.write_float64_r6d(os.path.join(tmp, "f64"))
    got = data_lib.load_data(d, "arm2wh", os.path.join(tmp, "f64_stats"), "e",
                             np.random.RandomState(23456))
    got = {**{k: got[k] for k in ("train_X", "train_Y", "val_X", "val_Y")},
           **{f"stat{i}": a for i, a in enumerate(got["stats"])}}
    ref = np.load(LEGACY_REF)
    err = {k: float(np.abs(v.astype(np.float64) - ref[k]).max()) for k, v in got.items()}
    same = all(v.dtype == ref[k].dtype and v.shape == ref[k].shape for k, v in got.items())
    exact = same and all(np.array_equal(v, ref[k]) for k, v in got.items())
    log(f"load_data on float64 clips vs the JAX legacy route's reference: dtypes and shapes "
        f"{'equal' if same else 'DIFFER'}, bit-equal {exact}, max abs err {max(err.values()):.3e}")
    if not (same and max(err.values()) <= LEGACY_ATOL):
        raise AssertionError(f"load_data on float64 clips: {err}")
    return {"bit_equal": exact, "max_abs_err": max(err.values())}


def options_phase(xyz, r6d):
    """bf16 forwards (v1, v4_deeper+text) at B=2048; the bf16 training run
    (``bf16_train``, the phase's main path) and bf16 inference; bf16 and
    fused_d steps (``step_pairs``); G, D and val rates at float32 and bf16
    and D rates fused, in turns; float64 clips through load_data.  Returns
    (robust-loss launches of the bf16 run, summary)."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_opt_") as tmp:
        data_dir = os.path.join(tmp, "data")
        os.makedirs(data_dir)
        io.save_binary(list(r6d), os.path.join(data_dir, "r6d_train"))
        io.save_binary(list(r6d[-N_VAL_CLIPS:]), os.path.join(data_dir, "r6d_val"))
        io.save_binary(xyz, os.path.join(data_dir, "xyz_train"))
        rng = np.random.default_rng(SEED + 3)
        for split, n in (("train", len(r6d)), ("val", N_VAL_CLIPS)):
            io.save_binary(rng.standard_normal((n, 512), dtype=np.float32),
                           os.path.join(data_dir, f"{split}_sentence_embeddings"))
        data = data_lib.load_data(data_dir, "arm2wh", os.path.join(tmp, "stats"), "opt",
                                  np.random.RandomState(23456), base_path=tmp,
                                  require_text=True)
        X, Y, F = data["train_X"], data["train_Y"], data["train_feats"]
        forwards = [bf16_forward("v1", None, X, None), bf16_forward("v4_deeper", "text", X, F)]
        launches, train = bf16_train(tmp, data_dir, data)
        steps = step_pairs(X, Y)
        rates = {}
        vX, vY = data["val_X"], data["val_Y"]
        base = gan.GanConfig(loss="RobustLoss", disc_label_smooth=True)
        trainers = {"float32": gan.GanTrainer(base, device="cuda"),
                    "bfloat16": gan.GanTrainer(dataclasses.replace(
                        base, compute_dtype="bfloat16"), device="cuda"),
                    "fused_d": gan.GanTrainer(dataclasses.replace(base, fused_d=True),
                                              device="cuda")}
        for kind, bs, a, b in (("g", TRAIN_BATCH, X, Y), ("d", TRAIN_BATCH, X, Y),
                               ("val", TRAIN_BATCH // 2, vX, vY)):
            for name in ("float32", "bfloat16", "fused_d", "float32", "bfloat16", "fused_d"):
                if name == "fused_d" and kind != "d":
                    continue
                rates.setdefault(f"{kind} {name}", []).append(timed_epochs(
                    trainers[name], a, b, kind, bs, True, repeats=5, label=f"v1 {name}"))
        legacy = legacy_load_data(tmp)
    summary = {"bf16_forward": forwards, "bf16_train": train, "steps": steps,
               "steps_per_s": rates, "float64_load_data": legacy}
    print(json.dumps({"options": summary}), flush=True)
    return launches, summary


# mesh phase: the multi-device paths (parallel/) on a one-rank NCCL group.
# The round's machine has one card and NCCL takes one rank per device
# (``nccl_two_ranks_one_card``), so every collective below is a real NCCL
# call over a group of one; across more ranks the paths are held on the
# CPU over gloo (tests/test_torch_mesh.py).
MESH_BATCH = 128
MESH_FWD_BATCH = 2048
MESH_LONG_T = 8704  # the raw phase's longest video
MESH_CLI_EPOCHS = 2  # with --epochs_train_disc 1: epoch 0 trains G and validates, 1 D
# the CLIs' epoch losses under torchrun against one process: the JAX
# package's bound for a DP epoch against one device (tests/test_multichip.py:58).
# A one-rank DP G step rounds its BatchNorm otherwise than PyTorch's own
# (5.6% of v1's G entries under the step check's sign-noise mask on the
# card), so the 4 G steps of epoch 0 leave weights a few lr apart, which
# the D epoch then reads: 1.07e-4 relative on the card, past the 1e-4 of
# the JAX package's single DP step (:42) that this bound first was.
MESH_CLI_LOSS_RTOL = 1e-3


def _mesh_step(kind, x, y, mesh, tp=False):
    """(loss, state_dict, gradients, Branches) of one ``kind`` step of v1
    arm2wh at full width from the seeded weights, dropout 0, with or without
    a mesh, its branches recorded; split weights and their gradients
    gathered into the reference layout."""
    cfg = gan.GanConfig(loss="RobustLoss", disc_label_smooth=True, batch_size=x.shape[0],
                        dropout_rate=0.0)
    tr = gan.GanTrainer(cfg, device="cuda", mesh=mesh, tp=tp)
    with Branches() as branches:
        loss = float(tr._step(kind)(torch.from_numpy(x).to("cuda"),
                                    torch.from_numpy(y).to("cuda")))
    module = tr.generator if kind == "g" else tr.discriminator
    grads = {}
    for name, p in module.named_parameters():
        if p.grad is None:
            continue
        owner = module.get_submodule(name.rsplit(".", 1)[0])
        g = p.grad
        if hasattr(owner, "tp_dim") and name.endswith("weight"):
            g = mesh_lib.gather_split(g, owner.tp_dim, mesh)
        grads[name] = g.double().cpu()
    sd = tr.checkpoint_payload(0)["state_dict" if kind == "g" else "discriminator"]
    return loss, {k: v.cpu() for k, v in sd.items()}, grads, branches


def hold_same_step(head, got, want, lr):
    """One step with a mesh against the same step without, both on the card:
    the loss at STEP_LOSS_RTOL, running statistics at STEP_ATOL, parameters
    at STEP_ATOL outside a mask of the entries whose gradient lies within
    STEP_NOISE_FACTOR of the two evaluations' largest disagreement in its
    tensor (a sign Adam's first step may take either way; such an entry
    within 2 lr + STEP_ATOL), the mask at most STEP_MASKED_SHARE."""
    loss, sd, grads = got[:3]
    loss0, sd0, grads0 = want[:3]
    worst = worst_masked = worst_stat = grad_err = grad_max = 0.0
    masked = total = 0
    for k, w in sd0.items():
        if k.endswith("num_batches_tracked"):
            continue
        diff = (sd[k].float() - w.float()).abs()
        if k not in grads0:
            worst_stat = max(worst_stat, float(diff.max()))
            continue
        e = float((grads[k] - grads0[k]).abs().max())
        grad_err, grad_max = max(grad_err, e), max(grad_max, float(grads0[k].abs().max()))
        keep = grads0[k].abs() >= STEP_NOISE_FACTOR * e
        masked += int((~keep).sum())
        total += keep.numel()
        worst = max(worst, float((diff * keep).max()))
        worst_masked = max(worst_masked, float((diff * ~keep).max()))
    row = {**head, "loss_mesh": loss, "loss": loss0,
           "loss_rel_err": abs(loss - loss0) / max(abs(loss0), 1e-30),
           "running_stat_err": worst_stat, "grad_err": grad_err, "grad_abs_max": grad_max,
           "param_err_outside_mask": worst, "param_err_inside_mask": worst_masked,
           "masked_share": masked / max(total, 1)}
    log("mesh step " + json.dumps(row))
    if not (row["loss_rel_err"] <= STEP_LOSS_RTOL and worst_stat <= STEP_ATOL
            and worst <= STEP_ATOL and worst_masked <= 2 * lr + STEP_ATOL
            and row["masked_share"] <= STEP_MASKED_SHARE):
        raise AssertionError(f"the mesh step {head} disagrees with the plain one: {row}")
    return row


def _mesh_cls_step(net, x, y, mesh):
    tr = clf_train.ClassifierTrainer(net, learning_rate=CLS_LR, weight_decay=CLS_WD,
                                     mesh=mesh)
    p0 = {k: v.detach().double().cpu() for k, v in net.state_dict().items()}
    loss, acc = tr.train_step(torch.from_numpy(x).to("cuda"),
                              torch.from_numpy(y - 1).to("cuda"))
    grads = {k: v.grad.double().cpu() + CLS_WD * p0[k]
             for k, v in net.state_dict(keep_vars=True).items()}
    return float(loss), {k: v.detach().cpu() for k, v in net.state_dict().items()}, grads, int(acc)


def _cli_losses(model_path, exp):
    with open(os.path.join(model_path, f"metrics_{exp}.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [(k, r[k]) for r in recs for k in ("loss_train_gen", "loss_val_gen",
                                              "loss_train_disc") if k in r]


def _torchrun(module, argv, tmp):
    """``python -m torch.distributed.run --standalone --nproc_per_node=1 -m
    module argv``; returns its standard output."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node=1", "-m", f"{train_gan.__package__}.{module}", *argv]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
    log(f"torchrun {module}: exit {proc.returncode} in {time.perf_counter() - t0:.1f} s")
    if proc.returncode != 0:
        raise AssertionError(f"torchrun {module} failed: {proc.stderr[-3000:]}")
    return proc.stdout


def mesh_cli(tmp, data_dir):
    """train_gan and inference under torchrun (one NCCL rank on the card)
    against the one-process CLIs on the same data."""
    common = ["--base_path", tmp, "--data_dir", data_dir, "--num_epochs",
              str(MESH_CLI_EPOCHS), "--epochs_train_disc", "1", "--batch_size",
              str(MESH_BATCH), "--loss", "RobustLoss", "--disc_label_smooth", "--device", "cuda"]
    one = os.path.join(tmp, "one")
    args = train_gan.build_parser().parse_args(common + ["--model_path", one])
    train_gan.main(args)
    out = _torchrun("train_gan", common + ["--model_path", os.path.join(tmp, "ranked")], tmp)
    if "data-parallel over Mesh(data=1, model=1, rank=0, device=cuda:0)" not in out:
        raise AssertionError(f"torchrun train_gan ran no mesh: {out[-2000:]}")
    a = _cli_losses(one, "experiment")
    b = _cli_losses(os.path.join(tmp, "ranked"), "experiment")
    rel = max(abs(x[1] - y[1]) / max(abs(x[1]), 1e-30) for x, y in zip(a, b))
    log(f"train_gan under torchrun vs one process: losses {b} vs {a}, rel err {rel:.3e}")
    if [k for k, _ in a] != [k for k, _ in b] or len(a) != 3 or rel > MESH_CLI_LOSS_RTOL:
        raise AssertionError("train_gan under torchrun disagrees with one process")

    ckpt = os.path.join(one, "experiment_checkpoint.pth")
    argv = ["--checkpoint", ckpt, "--data_dir", data_dir, "--infer_set", "val",
            "--device", "cuda", "--seqs_to_viz", "0"]
    cwd = os.getcwd()
    os.chdir(tmp)  # save_results writes root.pkl / bone_len.pkl to the cwd
    try:
        err_one = inference.main(inference.build_parser().parse_args(
            argv + ["--base_path", os.path.join(tmp, "inf_one")]))
    finally:
        os.chdir(cwd)
    out = _torchrun("inference", argv + ["--base_path", os.path.join(tmp, "inf_ranked")], tmp)
    err_ranked = float(re.search(r">>> TOTAL ERROR:\s+(\S+)", out).group(1))
    xyz = [io.load_binary(os.path.join(tmp, d, "results_experiment", "xyz_val.pkl"))
           for d in ("inf_one", "inf_ranked")]
    m = mpjpe(*xyz)
    log(f"inference under torchrun vs one process: L1 {err_ranked} vs {err_one}, "
        f"xyz MPJPE {m:.3e}")
    if not (abs(err_ranked - err_one) <= STEP_LOSS_RTOL * abs(err_one) and m <= MPJPE_BUDGET):
        raise AssertionError("inference under torchrun disagrees with one process")
    return {"train_losses": b, "loss_rel_err": rel, "inference_l1": err_ranked,
            "inference_mpjpe": m}


def nccl_group():
    """A one-rank NCCL process group on cuda:0 (a FileStore rendezvous)."""
    torch.cuda.set_device(0)
    fd, path = tempfile.mkstemp(prefix="chip_smoke_nccl_")
    os.close(fd)
    os.unlink(path)
    dist.init_process_group("nccl", store=dist.FileStore(path, 1), rank=0, world_size=1)
    return path


def mesh_phase(clips=None, xyz=None, r6d=None):
    """The multi-device paths on a one-rank NCCL group, each held against
    the same path without a mesh on the card.  Run alone it builds the
    kernels and lifts the serving clips first.  Returns (filter_sgd
    launches, robust_loss launches, the phase's rows)."""
    if clips is None:
        build_kernels(("filter_sgd", "robust_loss"))
        clips = synthetic_clips(np.random.RandomState(SEED), N_CLIPS)
        xyz, r6d = lift_to_r6d(clips)
    t_phase = time.perf_counter()
    rows = {}
    store = nccl_group()
    try:
        mesh = mesh_lib.get_mesh()
        log(f"mesh: {mesh} over backend {dist.get_backend()}")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
            data_dir = os.path.join(tmp, "data")
            os.makedirs(data_dir)
            io.save_binary(list(r6d), os.path.join(data_dir, "r6d_train"))
            io.save_binary(list(r6d[-N_VAL_CLIPS:]), os.path.join(data_dir, "r6d_val"))
            io.save_binary(xyz, os.path.join(data_dir, "xyz_train"))  # save_results' root
            data = data_lib.load_data(data_dir, "arm2wh", os.path.join(tmp, "stats"), "mesh",
                                      np.random.RandomState(23456), base_path=tmp)
            X, Y = data["train_X"][:MESH_BATCH], data["train_Y"][:MESH_BATCH]

            # the plain trainer's G, D and val steps and G step time first
            xt, yt = torch.from_numpy(X).to("cuda"), torch.from_numpy(Y).to("cuda")
            cfg = gan.GanConfig(loss="RobustLoss", disc_label_smooth=True)
            plain = {kind: _mesh_step(kind, X, Y, None) for kind in ("g", "d")}
            plain_tr = gan.GanTrainer(cfg, device="cuda")
            val = float(plain_tr.val_step(xt, yt))
            plain_ms = cuda_ms(lambda: plain_tr.g_step(xt, yt), reps=5)

            # the mesh path's G, D and val steps, DP and TP, held against them
            rl.robust_lossfun.launches = 0  # counts of the mesh steps start here
            dp_g = _mesh_step("g", X, Y, mesh)
            rows["steps"] = [hold_same_step({"step": kind, "tp": tp, "batch": MESH_BATCH},
                                            dp_g if (kind, tp) == ("g", False)
                                            else _mesh_step(kind, X, Y, mesh, tp), plain[kind],
                                            STEP_LR)
                             for kind in ("g", "d") for tp in (False, True)]
            # the DP G step against float64 as hold_step holds the plain card
            # step: the CPU's float32 step, float64 on its own branches and on
            # each float32 step's (one rank holds the global batch, so the
            # plain float64 step is the DP step's reference)
            cpu = _one_step("g", X, Y, "cpu")
            same = [_one_step("g", X, Y, "cpu", torch.float64, replay=run[3].taken)
                    for run in (dp_g, cpu)]
            rows["dp_g_float64"] = hold_step(
                {"step": "g", "mesh": "DP, one NCCL rank", "batch": MESH_BATCH,
                 "masked_share_against_plain": rows["steps"][0]["masked_share"]},
                dp_g, cpu, _one_step("g", X, Y, "cpu", torch.float64), STEP_LR, same)
            for tp in (False, True):
                got = float(gan.GanTrainer(cfg, device="cuda", mesh=mesh, tp=tp).val_step(xt, yt))
                log(f"mesh val step (tp {tp}): {got} against {val}")
                if abs(got - val) > STEP_LOSS_RTOL * abs(val):
                    raise AssertionError(f"the mesh val step disagrees: {got} vs {val}")

            # one DP G step traced: its collectives, NCCL's device time, the
            # robust loss launched; then timed against the plain step
            dp = gan.GanTrainer(cfg, device="cuda", mesh=mesh)
            dp.g_step(xt, yt)  # warm
            before = rl.robust_lossfun.launches
            traced = traced_collectives(lambda: dp.g_step(xt, yt))
            traced["robust_loss_launches"] = rl.robust_lossfun.launches - before
            traced["g_step_ms_mesh"] = cuda_ms(lambda: dp.g_step(xt, yt), reps=5)
            robust_launches = rl.robust_lossfun.launches  # end of the mesh steps
            traced["g_step_ms_plain"] = plain_ms
            rows["traced_g_step"] = traced
            log("mesh traced G step " + json.dumps(traced))
            if traced["robust_loss_launches"] != 1:
                raise AssertionError("the traced DP G step did not launch robust_loss once")
            if traced["collectives"] <= 0:
                raise AssertionError("the traced DP G step recorded no collective")

            # the classifier's DP step at full width against its plain step
            x, y = (np.ascontiguousarray(r6d_windows(r6d)[:CLS_STEP_BATCH]),
                    np.arange(1, CLS_STEP_BATCH + 1, dtype=np.int64))
            base = clf_models.build_classifier("lstm", device="cpu", dropout=0.0,
                                               **_lstm_kwargs(x.shape[-1], True))
            got = _mesh_cls_step(copy.deepcopy(base).to("cuda"), x, y, mesh)
            want = _mesh_cls_step(copy.deepcopy(base).to("cuda"), x, y, None)
            del base
            if got[3] != want[3]:
                raise AssertionError(f"classifier accuracy {got[3]} vs {want[3]}")
            rows["classifier"] = hold_same_step(
                {"step": "classifier", "batch": CLS_STEP_BATCH, "layers": CLS_LAYERS,
                 "bidirectional": True}, got[:3], want[:3], CLS_LR)

            # sharded inference at B=2048 against the plain forward
            Xf = np.resize(data["train_X"], (MESH_FWD_BATCH,) + X.shape[1:])
            net = registry.build_generator("v1", 36, 252, seed=SEED, device="cuda")
            fwd = {}
            for name, m in (("plain", None), ("mesh", mesh)):
                infer.run_inference(net, Xf, batch_size=MESH_FWD_BATCH, device="cuda", mesh=m)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fwd[name] = infer.run_inference(net, Xf, batch_size=MESH_FWD_BATCH,
                                                num_samples=MESH_FWD_BATCH, device="cuda",
                                                mesh=m)[0]
                fwd[name + "_s"] = time.perf_counter() - t0
            err = float(np.abs(fwd["mesh"] - fwd["plain"]).max())
            atol = FWD_REL_ATOL * float(np.abs(fwd["plain"]).max())
            rows["inference"] = {"batch": MESH_FWD_BATCH, "max_abs_err": err, "atol": atol,
                                 "mesh_s": fwd["mesh_s"], "plain_s": fwd["plain_s"]}
            log("mesh inference " + json.dumps(rows["inference"]))
            if not err <= atol:
                raise AssertionError(f"sharded inference off by {err}")

            # the serving clips' sharded lifting against the plain one
            fs.filter_sgd.launches = 0  # counts of the sharded lifting start here
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sharded = engine.lift_clips(clips, n_cycles=N_CYCLES, device="cuda", mesh=mesh)
            torch.cuda.synchronize()
            lift_s = time.perf_counter() - t0
            filter_launches = fs.filter_sgd.launches
            err = max(float(np.abs(a - b).max()) for a, b in zip(sharded, xyz))
            n_batches = len(engine._plan(clips))
            rows["lifting"] = {"clips": len(clips), "max_abs_err": err, "seconds": lift_s,
                               "filter_sgd_launches": filter_launches, "batches": n_batches}
            log("mesh lifting " + json.dumps(rows["lifting"]))
            if err > 1e-6 or filter_launches != n_batches:
                raise AssertionError(f"sharded lifting: {rows['lifting']}")

            # the time-sharded filter on one long clip against the kernel
            rows["time_sharded"] = time_sharded_check(mesh)

            rows["cli"] = mesh_cli(tmp, data_dir)
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.unlink(store)
    log(f"mesh phase: {time.perf_counter() - t_phase:.1f} s")
    return filter_launches, robust_launches, rows


def traced_collectives(fn):
    """Run ``fn`` under torch.profiler: its wall time, the collectives it
    called (c10d's host records), and the NCCL kernels' device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    calls, device = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if "nccl" in e.name.lower():
                device[e.name] = device.get(e.name, 0.0) + e.time_range.elapsed_us() * 1e-6
        elif e.name.startswith(("nccl:", "c10d::")):
            calls[e.name] = calls.get(e.name, 0) + 1
    return {"wall_s": wall, "collectives": sum(calls.values()),
            "collective_calls": calls, "nccl_kernels_s": device,
            "nccl_device_s": sum(device.values())}


def r6d_windows(r6d):
    """(N, 192, 288) r6d windows of the clips (the classifier's input)."""
    return windows.make_equal_len(r6d, method="cutting+reflect")[:, :, :288].astype(np.float32)


def time_sharded_check(mesh):
    """``filter_xyz_time_sharded`` at T=MESH_LONG_T and 900 cycles against
    ``filter_sgd`` on the same row with an all-ones mask, timed."""
    rng = np.random.RandomState(SEED + 5)
    kp = rng.uniform(100, 500, size=(MESH_LONG_T, 150)).astype(np.float32)
    kp[:, 2::3] = rng.uniform(0.5, 1.0, size=(MESH_LONG_T, 50))
    kps, masks, noises = (torch.from_numpy(a).to("cuda")
                          for a in engine._pack([(0, kp)], MESH_LONG_T))
    planes = engine._init_core(kps, masks, noises)
    t0 = time.perf_counter()
    got = sequence.filter_xyz_time_sharded(*(p[0] for p in planes), mesh, n_cycles=N_CYCLES)
    torch.cuda.synchronize()
    sharded_s = time.perf_counter() - t0
    ones = torch.ones_like(masks)
    before = fs.filter_sgd.launches
    want = fs.filter_sgd(*planes, ones, LR, N_CYCLES)
    kernel_ms = cuda_ms(lambda: fs.filter_sgd(*planes, ones, LR, N_CYCLES), reps=3)
    fs.filter_sgd.launches = before  # a comparison, not the path
    err = max(float((g - w[0]).abs().max()) for g, w in zip(got, want))
    row = {"T": MESH_LONG_T, "n_cycles": N_CYCLES, "max_abs_err": err,
           "sharded_s": sharded_s, "kernel_ms": kernel_ms}
    log("mesh time-sharded filter " + json.dumps(row))
    if not err <= FILTER_ATOL:
        raise AssertionError(f"the time-sharded filter is off by {err}")
    return row


def nccl_two_ranks_one_card(timeout=120):
    """Two NCCL ranks on cuda:0: start them under torchrun and report how it
    ends (NCCL takes one rank per device).  Not part of ``main``."""
    code = ("import os, torch, torch.distributed as dist; torch.cuda.set_device(0); "
            "dist.init_process_group('nccl'); t = torch.ones(4, device='cuda'); "
            "dist.all_reduce(t); torch.cuda.synchronize(); print('all_reduce', t.tolist())")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl2_") as tmp:
        path = os.path.join(tmp, "two_ranks.py")
        with open(path, "w") as f:
            f.write(code)
        proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run",
                                 "--standalone", "--nproc_per_node=2", path],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                start_new_session=True)
        try:
            out, rc = proc.communicate(timeout=timeout)[0], proc.returncode
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)  # torchrun and both ranks
            out, rc = proc.communicate()[0], "timeout"
    said = [ln for ln in out.splitlines()
            if any(w in ln for w in ("Duplicate", "NCCL", "all_reduce", "Error"))]
    log(f"two NCCL ranks on one card: exit {rc}; " + " | ".join(said[-6:]))
    return rc, said


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

    build_kernels(("filter_sgd", "robust_loss", "lift_init"))
    fp32 = filter_fp32_per_element_cycle()
    log(f"filter_sgd update: {fp32} FP32 instructions per element and cycle "
        "(SASS of the built library)")

    clips = synthetic_clips(np.random.RandomState(SEED), N_CLIPS)
    robust = robust_kernel_phase()
    rng = np.random.RandomState(SEED + 2)
    replay_robust = [hold_robust(N, D, rng) for N, D in replay_robust_shapes()]
    prod, path, init_path = kernel_phase(clips, fp32)
    init_prod = lift_init_production()
    launches, init_launches, xyz, r6d = path_phase(clips)
    t0 = time.perf_counter()
    lift_alt = lift_alt_phase()
    log(f"lifting-alternatives phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    raw_launches, raw, init_raw = raw_phase(fp32)
    log(f"raw phase: {time.perf_counter() - t0:.1f} s")
    robust_launches, viz, (X, Y) = train_phase(xyz, r6d)
    utils = utils_phase(X, Y)
    mesh_filter, mesh_robust, mesh_rows = mesh_phase(clips, xyz, r6d)
    t0 = time.perf_counter()
    options_launches, options = options_phase(xyz, r6d)
    log(f"options phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    robust_launches += conditioned_phase(xyz, r6d)
    log(f"conditioned phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    classifier_phase()
    log(f"classifier phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    replay = replay_phase(fp32, replay_robust)
    log(f"replay phase: {time.perf_counter() - t0:.1f} s")
    feat_launches = featurizer_phase()

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
        "launches_featurizers": feat_launches["filter_sgd"],  # not on that path
        # the demo (the single-clip v2 API), its counts read alone
        **lift_alt,
        # the serving clips' lifting sharded over a one-rank NCCL mesh, its
        # counts read alone, and the time-sharded filter held against it
        "launches_mesh": mesh_filter,
        "mesh_lift_s": mesh_rows["lifting"]["seconds"],
        "mesh_time_sharded": mesh_rows["time_sharded"],
    }, {
        "name": "lift_init",
        "route": "cuda",
        "source": "multimodal_hand_pose_enhancement_for_sign_language_tpu_torch/csrc/lift_init.cu",
        # no Pallas kernel: the XLA-compiled lax.scan over the bones
        "replaces": "multimodal_hand_pose_enhancement_for_sign_language_tpu/lifting/init3d.py:202",
        "launches": init_launches,
        "bit_equal": all(r["bit_equal"] for r in
                         init_prod + init_path + init_raw + replay["lift_init"]["replay_held"]),
        "held_batches": len(init_path) + len(init_raw) + len(replay["lift_init"]["replay_held"]),
        "production": [{k: r[k] for k in ("B", "T", "ms", "plain_ms", "bound_ms", "bound_by",
                                          "init_core_launches", "init_core_launches_plain")}
                       for r in init_prod],
        "library_ms": None,  # no single PyTorch call walks the tree
        "path_ms": sum(r["ms"] for r in init_path),
        "launches_raw": len(init_raw),
        "raw_path_ms": sum(r["ms"] for r in init_raw),
        **replay["lift_init"],
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
        "launches_featurizers": feat_launches["robust_loss"],  # not on that path
        # train_gan.main --bf16 (v1, 2 epochs), its counts read alone, and a
        # residual of that run held against the plain version
        "launches_options": options_launches,
        "options_held": options["bf16_train"]["residual_held"],
        # the mesh phase's DP and TP G and val steps and its traced DP G
        # step (one NCCL rank), its counts read alone
        "launches_mesh": mesh_robust,
        "mesh_traced_g_step": mesh_rows["traced_g_step"],
        # one G step traced through utils/profiling: the kernel in its trace
        "utils_trace": utils["trace"],
    }]
    log(f"viz phase: {viz['case']} in {viz['seconds']:.1f} s; utils phase "
        f"{utils['seconds']:.1f} s")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
