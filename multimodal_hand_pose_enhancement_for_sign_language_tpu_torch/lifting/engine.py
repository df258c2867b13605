"""Lifting engine: shape-bucketed batches of clips on one device.

PyTorch counterpart of the JAX package's ``lifting/engine.py``, which
replaces the reference's per-clip pipeline (utils/utils.py:44-137,
``Pool(24)`` over clips x [normalize -> prune -> initialization -> 900-step
SGD]).  Clips are padded into (batch, T-bucket) groups and each group runs
the whole pipeline batched; on a CUDA device the walk along the bone tree
and the 900-cycle filter are the hand-written kernels ``ops/lift_init`` and
``ops/filter_sgd``.  Per-clip noise reproduces the
reference's per-clip RandomState(1234) draws (utils/utils.py:46,66-74).

Every batch runs one filter, ``ops/filter_sgd.filter_sgd``: the CUDA
kernel on a CUDA tensor, its plain loop on a CPU tensor, and an error on
any other device.  No argument or environment variable selects another.

``lift_2d_to_3d`` keeps the reference's partitioned, append-on-checkpoint
file contract (utils/utils.py:120-137) so long runs resume from the last
saved partition.

With a ``mesh`` (``parallel/mesh.get_mesh``; every rank calls with the same
clips) each batch is padded to a multiple of 'data', each rank lifts its
rows (the kernel on the card) and the results are all-gathered: the
multi-device replacement for the reference's Pool(24) over clips, as the
JAX package's ``shard_map`` over clips.  Only rank 0 writes
``lift_2d_to_3d``'s pickles.
"""

from __future__ import annotations

import os
import pickle
import threading
from functools import lru_cache

import numpy as np
import torch
import torch.distributed as dist

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data.io import (
    load_binary,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.lifting import (
    init3d,
    pose2d,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops.filter_sgd import filter_sgd
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops.lift_init import lift_init
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.parallel import (
    mesh as mesh_lib,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.device import (
    resolve_device,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.profiling import (
    count,
    span,
)

_PRUNE_WATCH = (0, 1, 2, 3, 4, 5, 6, 7)
_PRUNE_THRESHOLD = 0.3
_NOISE_SIGMA = 0.001
_LR = 20.0
_N_CYCLES = 900
# batches enqueued on the device before the oldest is fetched
_IN_FLIGHT = 3


def _init_inputs(kps, masks, noises):
    """What the walk along the tree takes from a padded batch: normalization
    -> prune -> mask, the bone-length medians and the noisy roots
    (utils/utils.py:44-74, pose2Dto3D.py:73-116).

    kps (B, T, 150), masks (B, T), noises (B, 3, T); returns (Xx, Xy, Xw
    (B, T, 50), L_per_bone (B, 49), rootsx, rootsy, rootsz (B, T))."""
    Xx = kps[:, :, 0::3]
    Xy = kps[:, :, 1::3]
    Xw = kps[:, :, 2::3]

    Xx, Xy, _, _, _ = pose2d.normalization(Xx, Xy, mask=masks)
    Xx, Xy, Xw = pose2d.prune(Xx, Xy, Xw, _PRUNE_WATCH, _PRUNE_THRESHOLD)
    m = masks[:, :, None]
    Xx, Xy, Xw = Xx * m, Xy * m, Xw * m

    lines = init3d.bone_length_classes(Xx, Xy, mask=masks)
    roots = init3d.roots(Xx, Xy, _NOISE_SIGMA, noise=noises)
    return (Xx, Xy, Xw, init3d.bone_lengths(lines), *roots)


def _init_core(kps, masks, noises):
    """Pre-filter pipeline for a padded batch: normalization -> prune ->
    initialization -> FK snapshot (utils/utils.py:44-92, sans filtering),
    the walk along the tree and its FK in ``ops/lift_init`` (the kernel on
    the card).

    kps (B, T, 150), masks (B, T), noises (B, 3, T); returns
    (x0, y0, z0, Xx, Xy, Xw), each (B, T, 50)."""
    Xx, Xy, Xw, L_per_bone, rx, ry, rz = _init_inputs(kps, masks, noises)
    x0, y0, z0 = lift_init(Xx, Xy, L_per_bone, rx, ry, rz)
    return x0, y0, z0, Xx, Xy, Xw


def _interleave(Yx, Yy, Yz):
    """(B, T, 50) x3 -> (B, T, 150) with joint j at columns [3j, 3j+3)."""
    return torch.stack((Yx, Yy, Yz), dim=-1).reshape(*Yx.shape[:2], -1)


def _lift_batch(kps, masks, noises, n_cycles: int):
    with span("lift.init"):
        x0, y0, z0, Xx, Xy, Xw = _init_core(kps, masks, noises)
    return _interleave(*filter_sgd(x0, y0, z0, Xx, Xy, Xw, masks, _LR, n_cycles))


def _clip_noise(T: int, sigma: float = _NOISE_SIGMA) -> np.ndarray:
    """The reference's per-clip noise: RandomState(1234) drawing T uniforms
    for rootsx, then rootsy, then rootsz (utils/utils.py:46, addNoise at
    pose2Dto3D.py:85-87).  Depends only on the clip LENGTH, so draws are
    cached per T (a 31K-clip run otherwise spins up 31K RandomStates)."""
    return _clip_noise_cached(T, sigma).copy()


@lru_cache(maxsize=4096)
def _clip_noise_cached(T: int, sigma: float) -> np.ndarray:
    rng = np.random.RandomState(1234)
    return np.stack(
        [
            rng.uniform(-sigma, sigma, size=T).astype(np.float32)
            for _ in range(3)
        ]
    )


def _plan(clips, t_bucket: int = 64, max_batch: int = 128) -> list:
    """The batches ``lift_clips`` runs, in order: a list of (tb, chunk),
    chunk a list of (clip index, (T, 150) float32 clip) with T <= tb.
    Clips group by T rounded up to a multiple of ``t_bucket``; each group
    splits into chunks of at most ``max_batch`` clips."""
    groups: dict = {}
    for i, c in enumerate(clips):
        c = np.asarray(c, np.float32)
        tb = -(-max(c.shape[0], 1) // t_bucket) * t_bucket
        groups.setdefault(tb, []).append((i, c))
    return [
        (tb, members[start : start + max_batch])
        for tb, members in groups.items()
        for start in range(0, len(members), max_batch)
    ]


def _pack(chunk, tb: int, n_data: int = 1):
    """One batch as host arrays: kps (nb, tb, 150), masks (nb, tb), noises
    (nb, 3, tb), nb the chunk size padded to a power of two, then to a
    multiple of ``n_data`` (padded rows are all-masked)."""
    nb = 1
    while nb < len(chunk):
        nb *= 2
    nb = mesh_lib.pad_to_multiple(nb, n_data)
    kps = np.zeros((nb, tb, 150), np.float32)
    masks = np.zeros((nb, tb), np.float32)
    noises = np.zeros((nb, 3, tb), np.float32)
    for slot, (_, c) in enumerate(chunk):
        kps[slot, : c.shape[0]] = c
        masks[slot, : c.shape[0]] = 1.0
        noises[slot, :, : c.shape[0]] = _clip_noise(c.shape[0])
    return kps, masks, noises


def lift_clip(kp, n_cycles: int = _N_CYCLES, device="cuda") -> np.ndarray:
    """Lift one (T, 150) 2D-keypoint clip to 3D (drop-in for the reference's
    utils/utils.py:_lift_2d_to_3d)."""
    return lift_clips([np.asarray(kp)], n_cycles=n_cycles, device=device)[0]


def lift_clips(clips, n_cycles: int = _N_CYCLES, t_bucket: int = 64,
               max_batch: int = 128, device="cuda", mesh=None) -> list:
    """Lift a list of (T_i, 150) clips to (T_i, 150) xyz, shape-bucketed.

    Clips group by T rounded up to a multiple of ``t_bucket``; each group
    runs in batches of at most ``max_batch`` clips, padded to a power of
    two (``_plan``, ``_pack``).  Batches are enqueued ahead and fetched
    behind (at most ``_IN_FLIGHT`` on the device), so the host stages batch
    k+1 while the device computes batch k.  ``mesh``: each rank
    lifts its rows of every batch (module docstring); every rank returns
    all clips.  With the tracer on (``utils/profiling``): spans
    ``lift.pack`` (the plan, then each batch's packing and copies in),
    ``lift.init`` (each batch's ``_init_core``) and ``lift.drain`` (each
    batch's copy out and unpacking); counters ``lift.live_frames`` (the clips'
    frames) and ``lift.padded_frames`` (rows x T-bucket of every batch).
    """
    dev = resolve_device(device)
    n_data = 1
    if mesh is not None:
        mesh.check_device(dev)
        n_data = mesh.shape["data"]
    on = f"{dev}" if mesh is None else f"{mesh}"
    print(f"lift_clips: {len(clips)} clips on {on}", flush=True)
    out = [None] * len(clips)
    pending: list = []

    def drain(entry):
        with span("lift.drain"):
            chunk, res_dev = entry
            res = res_dev.cpu().numpy()
            for slot, (i, c) in enumerate(chunk):
                out[i] = res[slot, : c.shape[0]]

    with span("lift.pack"):
        plan = _plan(clips, t_bucket, max_batch)
    for tb, chunk in plan:
        with span("lift.pack"):
            batch = _pack(chunk, tb, n_data)
            count("lift.live_frames", sum(c.shape[0] for _, c in chunk))
            count("lift.padded_frames", batch[1].size)
            if mesh is None:
                batch = [torch.from_numpy(a).to(dev) for a in batch]
            else:
                batch = mesh_lib.local_rows(batch, mesh)[0]
        res = _lift_batch(*batch, n_cycles)
        if mesh is not None:
            res = mesh_lib.gather_rows(res, mesh.data_group, n_data)
        pending.append((chunk, res))
        if len(pending) > _IN_FLIGHT:
            drain(pending.pop(0))
    for entry in pending:
        drain(entry)
    return out


def _atomic_save(obj, filename: str) -> None:
    """save_binary's naming contract with a temp-file + rename write, so a
    crash mid-pickle never leaves a truncated checkpoint (the resume path
    trusts whatever it finds on disk)."""
    final = filename if filename.endswith(".pkl") else filename + ".pkl"
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(obj, f, pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, final)


class _CheckpointWriter(threading.Thread):
    """Background ``_atomic_save`` whose failure re-raises at ``join()``, so
    a failed checkpoint write (disk full, ...) aborts the run instead of
    letting a later resume restart from an older on-disk prefix."""

    def __init__(self, obj, filename):
        super().__init__(target=_atomic_save, args=(obj, filename))
        self.exc = None

    def run(self):
        try:
            super().run()
        except BaseException as e:  # re-raised at join()
            self.exc = e

    def join(self, timeout=None):
        super().join(timeout)
        if self.exc is not None:
            raise self.exc


def lift_2d_to_3d(feats, filename: str = "feats_3d", nPartitions: int = 40,
                  n_cycles: int = _N_CYCLES, device="cuda", mesh=None):
    """Partitioned, resumable lifting over a clip list (utils/utils.py:120-137):
    results are appended to ``filename`` one partition at a time, so a
    crashed run resumes after the last partition on disk.  Partition k's
    pickle is written by a background thread while partition k+1 lifts,
    joined before the next write so the file is always a consistent prefix.
    ``mesh``: ``lift_clips`` over it; rank 0 alone writes, and every rank
    waits at a barrier for its last write before returning, so a resumed
    run on any rank reads a complete file.
    """
    write = mesh is None or mesh.rank == 0
    feats_3d = []
    if os.path.exists(filename):
        print(f" -> Found file with name {filename}. Appending results.", flush=True)
        feats_3d = load_binary(filename)
    idx = len(feats) // nPartitions + 1
    done = len(feats_3d)
    writer = None
    try:
        for i in range(nPartitions):
            chunk = feats[idx * i : idx * (i + 1)]
            if not chunk:
                continue
            if min(idx * (i + 1), len(feats)) <= done:
                continue  # partition already lifted in a previous run
            lifted = lift_clips(chunk, n_cycles=n_cycles, device=device, mesh=mesh)
            # rebinding (not mutating) keeps the list handed to the writer
            # thread unchanged
            feats_3d = feats_3d + lifted
            if not write:
                continue
            if writer is not None:
                writer.join()
            writer = _CheckpointWriter(feats_3d, filename)
            writer.start()
            print(f"LIFTED {int((i + 1) / nPartitions * 100)}%", flush=True)
    finally:
        if writer is not None:
            writer.join()
    if mesh is not None:
        dist.barrier()
    return feats_3d
