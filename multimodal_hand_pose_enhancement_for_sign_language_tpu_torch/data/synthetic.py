"""Deterministic synthetic How2Sign-like fixtures.

The port's copy of the JAX package's ``data/synthetic.py``, built on the
port's own geometry (``ops/{kinematics,rotations}``) and pickles
(``data/io``).  The reference hard-codes cluster dataset paths
(proc_text.py:9-13, proc_vid.py:16-26, proc_categ.py:6-12), so a fake-data
generator is the only way to exercise the pipeline hermetically:

  * ``make_openpose_tree``   -- raw-format fixture: OpenPose per-frame JSON
    directories + `<id> <sentence>` text files + videoID,categoryID CSVs,
    laid out exactly like the How2Sign utterance-level release.
  * ``make_r6d_dataset``     -- processed-format fixture: the pickles the
    training/inference entry points consume (r6d_{set}.pkl, xyz_{set}.pkl,
    {set}_sentence_embeddings.pkl, {set}_vid_feats.pkl, categs_{set}.pkl),
    generated through the port's geometry ops so they are mutually
    consistent (r6d <-> aa <-> xyz).  Its FK, IK and r6d conversion run on
    ``device``; the categories and the embeddings are numpy's alone, equal
    to the JAX package's for the same seed.
"""

from __future__ import annotations

import json
import os

import numpy as np

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data.io import save_binary
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops import (
    kinematics,
    rotations,
    skeleton,
)

SPLITS = ("train", "val", "test")


def _utt_id(video_idx: int, utt_idx: int) -> str:
    # first 11 characters form the video id (utils/utils.py:180)
    return f"vid{video_idx:08d}-{utt_idx}-rgb_front"


def make_openpose_tree(
    root: str,
    n_videos: int = 2,
    utts_per_video: int = 2,
    frames: int = 8,
    seed: int = 0,
):
    """Write a raw OpenPose-format dataset under `root`.

    Returns dict with 'dataset_path', 'text_paths', 'categ_paths'.
    """
    rng = np.random.RandomState(seed)
    text_paths, categ_paths = {}, {}
    for split in SPLITS:
        json_root = os.path.join(
            root, split, "rgb_front", "features", "openpose_output", "json"
        )
        os.makedirs(json_root, exist_ok=True)
        lines = []
        categ_rows = ["videoID,categoryID"]
        for v in range(n_videos):
            vid = _utt_id(v, 0)[:11]
            categ_rows.append(f"{vid},{1 + (v % 9)}")
            for u in range(utts_per_video):
                uid = _utt_id(v, u)
                utt_dir = os.path.join(json_root, uid)
                os.makedirs(utt_dir, exist_ok=True)
                lines.append(f"{uid} synthetic sentence about topic {v}.")
                for t in range(frames):
                    body = rng.uniform(100, 500, size=25 * 3)
                    body[2::3] = rng.uniform(0.5, 1.0, size=25)
                    rh = rng.uniform(100, 500, size=21 * 3)
                    rh[2::3] = rng.uniform(0.5, 1.0, size=21)
                    lh = rng.uniform(100, 500, size=21 * 3)
                    lh[2::3] = rng.uniform(0.5, 1.0, size=21)
                    frame = {
                        "people": [
                            {
                                "pose_keypoints_2d": body.tolist(),
                                "hand_right_keypoints_2d": rh.tolist(),
                                "hand_left_keypoints_2d": lh.tolist(),
                            }
                        ]
                    }
                    fname = f"{uid}_{t:012d}_keypoints.json"
                    with open(os.path.join(utt_dir, fname), "w") as f:
                        json.dump(frame, f)
        text_path = os.path.join(root, f"{split}.text.id.en")
        with open(text_path, "w") as f:
            f.write("\n".join(lines) + "\n")
        text_paths[split] = text_path
        categ_path = os.path.join(root, f"videoID_categoryID_{split}.csv")
        with open(categ_path, "w") as f:
            f.write("\n".join(categ_rows) + "\n")
        categ_paths[split] = categ_path
    return {
        "dataset_path": root,
        "text_paths": text_paths,
        "categ_paths": categ_paths,
    }


# width of the per-frame ResNet image features (b2h's conditioning input)
IMAGE_DIM = 2000


def make_r6d_dataset(
    data_dir: str,
    n_clips: int = 6,
    t_range: tuple[int, int] = (40, 240),
    seed: int = 0,
    text_dim: int = 512,
    save_image_feats: bool = True,
    categ_signal: bool = False,
    device="cuda",
):
    """Write processed pickles for all three splits under `data_dir`.

    The r6d data is geometrically valid: random smooth axis-angle curves
    run through FK to xyz, back through IK to aa, then to r6d — matching
    what the real pipeline produces.

    `save_image_feats=False` skips the (T, IMAGE_DIM) per-clip ResNet-feature
    pickles.

    By default the categoryID labels (`1 + i % 9`) carry no information
    about the pose/text content (so classifier accuracy on the fixture is
    chance — the honest default for plumbing tests).  `categ_signal=True`
    makes the labels learnable: each class k adds a distinct per-frame
    angular oscillation frequency to the axis-angle curves (which survives
    the FK→IK→r6d round trip into the classifier's input windows) and a
    class centroid to the sentence embeddings — so the downstream LSTM /
    text-MLP surrogate evaluation (article §5.2,
    H2Sclassifier/Train_Test/main.py:23-121) can be
    tested for actual above-chance learning, not just plumbing.  The
    default-False path consumes the RNG identically with or without this
    flag, so existing fixtures stay byte-identical.

    The FK, IK and r6d conversions run on ``device``.
    """
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    root = np.array([0.0, 0.0, 0.0, 0.0, 1.0, 0.0], dtype=np.float32)
    bone_len = rng.uniform(0.5, 1.5, size=(skeleton.N_BONES,)).astype(np.float32)

    out = {}
    for split in SPLITS:
        n = n_clips if split == "train" else max(2, n_clips // 2)
        aa_clips = []
        for i in range(n):
            T = int(rng.randint(*t_range))
            base = rng.uniform(0.3, 1.0, size=(1, 144))
            wob = 0.1 * np.sin(
                np.linspace(0, 6, T)[:, None] + rng.uniform(0, 3, size=(1, 144))
            )
            clip = base + wob
            if categ_signal:
                # class k's signature: a per-class mean angular offset
                # (readable at any timestep) plus a distinct per-frame
                # oscillation frequency (periods ~5..23 frames, well
                # inside one 192-frame classifier window), on every joint
                # channel; deterministic in k, so the main RNG stream is
                # untouched
                k = 1 + (i % 9)
                omega = 0.15 + 0.12 * k
                t = np.arange(T, dtype=np.float64)[:, None]
                c = np.arange(144, dtype=np.float64)[None, :]
                csig = 0.08 * k + 0.35 * np.sin(omega * t + 0.5 * c)
                clip = clip + csig
            aa_clips.append(clip.astype(np.float32))
        xyz = kinematics.aa_to_xyz(aa_clips, root, bone_len, device=device)
        # IK's canonical angles, as the real pipeline's xyz->aa produces them
        aa_final = kinematics.xyz_to_aa(xyz, device=device)
        r6d = rotations.aa_to_rot6d(aa_final, device=device)
        save_binary(r6d, os.path.join(data_dir, f"r6d_{split}.pkl"))
        save_binary(xyz, os.path.join(data_dir, f"xyz_{split}.pkl"))

        embeds = rng.randn(n, text_dim).astype(np.float32)
        if categ_signal:
            # class centroids from a fixed side-stream (the main RNG is
            # not consumed), strong enough for a linear probe / the
            # SentenceClassifier MLP to separate
            cents = np.random.RandomState(seed + 4242).randn(9, text_dim)
            embeds = embeds + 2.0 * cents[
                np.arange(n) % 9
            ].astype(np.float32)
        save_binary(embeds, os.path.join(data_dir, f"{split}_sentence_embeddings.pkl"))
        save_binary(
            np.tile(embeds.mean(axis=0), (n, 1)),
            os.path.join(data_dir, f"average_{split}_sentence_embeddings.pkl"),
        )
        if save_image_feats:
            feats = [
                rng.randn(c.shape[0], IMAGE_DIM).astype(np.float32)
                for c in r6d
            ]
            save_binary(
                feats, os.path.join(data_dir, f"{split}_vid_feats.pkl")
            )
        categs = [1 + (i % 9) for i in range(n)]
        save_binary(categs, os.path.join(data_dir, f"categs_{split}.pkl"))
        out[split] = dict(n=n)
    return out
