"""Lifting engine: shape-bucketed batches of clips on one device.

PyTorch counterpart of the JAX package's ``lifting/engine.py``, which
replaces the reference's per-clip pipeline (utils/utils.py:44-137,
``Pool(24)`` over clips x [normalize -> prune -> initialization -> 900-step
SGD]).  Clips are padded into (batch, T-bucket) groups and each group runs
the whole pipeline batched; on a CUDA device the 900-cycle filter is the
hand-written kernel ``ops/filter_sgd``.  Per-clip noise reproduces the
reference's per-clip RandomState(1234) draws (utils/utils.py:46,66-74).

The filter is chosen by the caller's ``filter_impl``, with the JAX
package's names: 'pallas' (the default) is ``ops/filter_sgd.filter_sgd``
(the CUDA kernel on the card, its plain loop on the CPU), 'matpow' the
closed form ``filtering.filter_xyz_matpow`` (T up to ``MATPOW_MAX_T``, at
``matpow_precision``), 'xla' the plain loop on any device.  No environment
variable selects it, so the entry points that do not name one
(``lift_clip``, ``lift_2d_to_3d``) always run the kernel on the card.
``lift_clips`` prints which filter ran.

``lift_2d_to_3d`` keeps the reference's partitioned, append-on-checkpoint
file contract (utils/utils.py:120-137) so long runs resume from the last
saved partition.
"""

from __future__ import annotations

import os
import pickle
import threading
from functools import lru_cache

import numpy as np
import torch

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data.io import (
    load_binary,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.lifting import (
    filtering,
    init3d,
    pose2d,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops.filter_sgd import (
    filter_sgd,
    filter_sgd_plain,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.device import (
    resolve_device,
)

_PRUNE_WATCH = (0, 1, 2, 3, 4, 5, 6, 7)
_PRUNE_THRESHOLD = 0.3
_NOISE_SIGMA = 0.001
_LR = 20.0
_N_CYCLES = 900
# the longest T-bucket that filter_impl='matpow' takes: its (B, 50, T, T)
# float32 operators are B * 50 * T^2 * 4 bytes each (1.7 GB at B=128)
MATPOW_MAX_T = 256
FILTER_IMPLS = ("pallas", "xla", "matpow")
# batches enqueued on the device before the oldest is fetched
_IN_FLIGHT = 3


def _init_core(kps, masks, noises):
    """Pre-filter pipeline for a padded batch: normalization -> prune ->
    initialization -> FK snapshot (utils/utils.py:44-92, sans filtering).

    kps (B, T, 150), masks (B, T), noises (B, 3, T); returns
    (x0, y0, z0, Xx, Xy, Xw), each (B, T, 50)."""
    Xx = kps[:, :, 0::3]
    Xy = kps[:, :, 1::3]
    Xw = kps[:, :, 2::3]

    Xx, Xy, _, _, _ = pose2d.normalization(Xx, Xy, mask=masks)
    Xx, Xy, Xw = pose2d.prune(Xx, Xy, Xw, _PRUNE_WATCH, _PRUNE_THRESHOLD)
    m = masks[:, :, None]
    Xx, Xy, Xw = Xx * m, Xy * m, Xw * m

    lines0, rx, ry, rz, ax, ay, az, _, _, _ = init3d.initialization(
        Xx, Xy, Xw, _NOISE_SIGMA, noise=noises, mask=masks
    )
    x0, y0, z0 = filtering.fk_from_angles(lines0, rx, ry, rz, ax, ay, az)
    return x0, y0, z0, Xx, Xy, Xw


def _interleave(Yx, Yy, Yz):
    """(B, T, 50) x3 -> (B, T, 150) with joint j at columns [3j, 3j+3)."""
    return torch.stack((Yx, Yy, Yz), dim=-1).reshape(*Yx.shape[:2], -1)


def _lift_batch(kps, masks, noises, n_cycles: int, filter_impl: str = "pallas",
                matpow_precision: str = "float32"):
    x0, y0, z0, Xx, Xy, Xw = _init_core(kps, masks, noises)
    args = (x0, y0, z0, Xx, Xy, Xw, masks)
    if filter_impl == "pallas":
        Yx, Yy, Yz = filter_sgd(*args, _LR, n_cycles)
    elif filter_impl == "matpow":
        T = x0.shape[1]
        if T > MATPOW_MAX_T:
            raise ValueError(
                f"filter_impl='matpow' materializes a (B, 50, {T}, {T}) operator; "
                f"T={T} exceeds the supported bound {MATPOW_MAX_T}.  Use "
                "filter_impl='pallas' for long-clip buckets.")
        Yx, Yy, Yz = filtering.filter_xyz_matpow(
            *args, learning_rate=_LR, n_cycles=n_cycles, precision=matpow_precision)
    elif filter_impl == "xla":
        Yx, Yy, Yz = filter_sgd_plain(*args, _LR, n_cycles)
    else:
        raise ValueError(f"unknown filter_impl {filter_impl!r}; expected one of "
                         f"{FILTER_IMPLS}")
    return _interleave(Yx, Yy, Yz)


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


def _pack(chunk, tb: int):
    """One batch as host arrays: kps (nb, tb, 150), masks (nb, tb), noises
    (nb, 3, tb), nb the chunk size padded to a power of two (padded rows
    are all-masked)."""
    nb = 1
    while nb < len(chunk):
        nb *= 2
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
               max_batch: int = 128, device="cuda", filter_impl: str = "pallas",
               matpow_precision: str = "float32") -> list:
    """Lift a list of (T_i, 150) clips to (T_i, 150) xyz, shape-bucketed.

    Clips group by T rounded up to a multiple of ``t_bucket``; each group
    runs in batches of at most ``max_batch`` clips, padded to a power of
    two (``_plan``, ``_pack``).  Batches are enqueued ahead and fetched
    behind (at most ``_IN_FLIGHT`` on the device), so the host stages batch
    k+1 while the device computes batch k.  ``filter_impl`` ('pallas', 'xla'
    or 'matpow') picks the filter and ``matpow_precision`` ('float32',
    'tensorfloat32' or 'bfloat16') matpow's products.
    """
    dev = resolve_device(device)
    if filter_impl not in FILTER_IMPLS:
        raise ValueError(f"unknown filter_impl {filter_impl!r}; expected one of "
                         f"{FILTER_IMPLS}")
    at = f" at {matpow_precision}" if filter_impl == "matpow" else ""
    print(f"lift_clips: {len(clips)} clips, filter {filter_impl!r}{at} on {dev}", flush=True)
    out = [None] * len(clips)
    pending: list = []

    def drain(entry):
        chunk, res_dev = entry
        res = res_dev.cpu().numpy()
        for slot, (i, c) in enumerate(chunk):
            out[i] = res[slot, : c.shape[0]]

    for tb, chunk in _plan(clips, t_bucket, max_batch):
        res = _lift_batch(
            *(torch.from_numpy(a).to(dev) for a in _pack(chunk, tb)), n_cycles,
            filter_impl, matpow_precision,
        )
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
                  n_cycles: int = _N_CYCLES, device="cuda"):
    """Partitioned, resumable lifting over a clip list (utils/utils.py:120-137):
    results are appended to ``filename`` one partition at a time, so a
    crashed run resumes after the last partition on disk.  Partition k's
    pickle is written by a background thread while partition k+1 lifts,
    joined before the next write so the file is always a consistent prefix.
    """
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
            lifted = lift_clips(chunk, n_cycles=n_cycles, device=device)
            # rebinding (not mutating) keeps the list handed to the writer
            # thread unchanged
            feats_3d = feats_3d + lifted
            if writer is not None:
                writer.join()
            writer = _CheckpointWriter(feats_3d, filename)
            writer.start()
            print(f"LIFTED {int((i + 1) / nPartitions * 100)}%", flush=True)
    finally:
        if writer is not None:
            writer.join()
    return feats_3d
