"""OpenPose JSON ingestion and utterance/clip grouping.

The port's copy of the JAX package's ``data/openpose.py``, the re-design of
the reference's utils/utils.py:140-279: the same on-disk format (per-frame
OpenPose BODY_25 + hand JSON files in one directory per utterance), the same
outputs (lists of (T, 3*k) float64 arrays of x, y, confidence triplets).
Frames go through the port's native C++ scanner (``runtime/native.py``)
when it builds, else through Python's json; utterances fan out over spawn
worker processes.  This module imports numpy only, so that those workers
start fast.

``FRAMES`` counts the frames parsed in this process (any thread) and in its
workers, by parser: ``{"native": n, "json": n}``.
"""

from __future__ import annotations

import json
import os
import re
import threading
from concurrent.futures import ProcessPoolExecutor

import numpy as np

FRAMES = {"native": 0, "json": 0}
_frames_lock = threading.Lock()


def natural_keys(text: str):
    """Natural sort key (reference proc_text.py:18-25)."""

    def atof(t):
        try:
            return float(t)
        except ValueError:
            return t

    return [atof(c) for c in re.split(r"[+-]?([0-9]+(?:[.][0-9]*)?|[.][0-9]+)", text)]


def retrieve_coords(keypoints):
    """Keep [x, y, w] triplets as a flat list (utils/utils.py:142-148)."""
    coords = []
    for i in range(0, len(keypoints), 3):
        coords.append(keypoints[i])
        coords.append(keypoints[i + 1])
        coords.append(keypoints[i + 2])
    return coords


def parse_frame_json(data: dict) -> tuple[np.ndarray, np.ndarray]:
    """One OpenPose frame dict -> (body_25 kp (75,), hands kp (126,))."""
    person = data["people"][0]
    in_kp = np.asarray(person["pose_keypoints_2d"], dtype=np.float64)
    out_kp = np.concatenate(
        [
            np.asarray(person["hand_right_keypoints_2d"], dtype=np.float64),
            np.asarray(person["hand_left_keypoints_2d"], dtype=np.float64),
        ]
    )
    return in_kp, out_kp


def _read_utterance(clip_path: str, use_native=None):
    """(in_kp (T, 75), out_kp (T, 126), frames the native scanner parsed)."""
    from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.runtime import (
        native,
    )

    if use_native is None:
        use_native = native.native_available()

    in_rows, out_rows = [], []
    n_native = 0
    for frame in sorted(os.listdir(clip_path)):
        path = os.path.join(clip_path, frame)
        if not os.path.isfile(path):
            continue
        if use_native:
            with open(path, "rb") as f:
                parsed = native.parse_openpose_frame_bytes(f.read())
            if parsed is not None:
                in_rows.append(parsed[0])
                out_rows.append(parsed[1])
                n_native += 1
                continue
            use_native = False  # library vanished mid-run: fall back
        with open(path) as f:
            data = json.load(f)
        i, o = parse_frame_json(data)
        in_rows.append(i)
        out_rows.append(o)
    if not in_rows:
        return np.zeros((0, 75)), np.zeros((0, 126)), 0
    return np.stack(in_rows), np.stack(out_rows), n_native


def _count(n_frames: int, n_native: int) -> None:
    with _frames_lock:
        FRAMES["native"] += n_native
        FRAMES["json"] += n_frames - n_native


def load_utterance(clip_path: str, pipeline: str = "arm2wh", use_native=None):
    """Read all frame JSONs of one utterance directory.

    Returns (in_kp (T, 75), out_kp (T, 126)) like utils/utils.py:151-170;
    body 25 keypoints as input stream, right+left hand 21+21 as output.
    ``use_native`` None takes the C++ scanner when it builds.
    """
    in_kp, out_kp, n_native = _read_utterance(clip_path, use_native)
    _count(len(in_kp), n_native)
    return in_kp, out_kp


def _load(args):
    clip, directory, pipeline = args
    in_kp, out_kp, n_native = _read_utterance(os.path.join(directory, clip))
    return clip, in_kp, out_kp, n_native


def worker_pool(max_workers=None, n_tasks=None) -> ProcessPoolExecutor:
    """The ingestion's spawn pool: forking a process that has initialised
    CUDA (or any multithreaded runtime) can deadlock.  ``max_workers`` None
    takes the cores this process may run on (not every core of the host),
    at most one a task."""
    import multiprocessing as mp

    if max_workers is None:
        max_workers = len(os.sched_getaffinity(0))
        if n_tasks is not None:
            max_workers = max(1, min(n_tasks, max_workers))
    return ProcessPoolExecutor(max_workers=max_workers,
                               mp_context=mp.get_context("spawn"))


def load_utterances_parallel(ids, directory, pipeline="arm2wh", max_workers=None,
                             pool=None):
    """Parallel fan-out over utterances (replaces ProcessPoolExecutor use
    at utils/utils.py:248-249), in ``pool`` if given (``worker_pool``; one
    pool serves every split of a dataset), else in a pool of its own.  The
    native scanner is built here first, so that the workers load it."""
    from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.runtime import (
        native,
    )

    native.native_available()
    tasks = [(c, directory, pipeline) for c in ids]
    if pool is None:
        with worker_pool(max_workers, len(ids)) as own:
            result = list(own.map(_load, tasks))
    else:
        result = list(pool.map(_load, tasks))
    for _, in_kp, _, n_native in result:
        _count(len(in_kp), n_native)
    clips, in_features, out_features = (list(r[k] for r in result) for k in range(3))
    return clips, in_features, out_features


def group_clips(clips, in_features, out_features):
    """Group utterance sequences into video clips by 11-char video id.

    Reference: utils/utils.py:173-202 (_groupClips) — natural-sorted
    concatenation per video id, outputs sorted by clip id.
    """
    assert len(clips) == len(in_features) == len(out_features)
    temp = sorted(
        zip(clips, in_features, out_features), key=lambda x: natural_keys(x[0])
    )
    clips_grouped = []
    in_grouped: dict = {}
    out_grouped: dict = {}
    for cid, i_feat, o_feat in temp:
        clip_id = cid[:11]
        if clip_id not in in_grouped:
            clips_grouped.append(clip_id)
            in_grouped[clip_id] = i_feat
            out_grouped[clip_id] = o_feat
        else:
            in_grouped[clip_id] = np.concatenate((in_grouped[clip_id], i_feat), axis=0)
            out_grouped[clip_id] = np.concatenate((out_grouped[clip_id], o_feat), axis=0)

    clips_grouped = sorted(clips_grouped)
    in_features_grouped = [v for _, v in sorted(in_grouped.items())]
    out_features_grouped = [v for _, v in sorted(out_grouped.items())]
    return clips_grouped, in_features_grouped, out_features_grouped


# camelCase alias matching the reference symbol
_groupClips = group_clips


def get_joints(kp, idx):
    """Reference: utils/utils.py:360-361."""
    return kp[:, idx]


def select_keypoints(kp, idxs, keep_confidence=True):
    """Select joints by index from each clip of a list (utils/utils.py:
    365-375), as one gather instead of per-index hstack loops."""
    step = 3 if keep_confidence else 2
    cols = np.concatenate([np.arange(i * 3, i * 3 + step) for i in idxs])
    return [np.asarray(c)[:, cols] for c in kp]


def hconcat_feats(neck, arms, hands):
    """Reference: utils/utils.py:378-384."""
    assert [len(neck), len(arms)] == [len(hands), len(hands)]
    return [
        np.hstack((np.hstack((n, a)), h)) for n, a, h in zip(neck, arms, hands)
    ]
