"""Train-set standardization statistics.

Reproduces the reference's asymmetric mean/std rule exactly
(utils/standardization_utils.py:37-59):

  * mean: per-channel, averaged over time then over clips — shape (1, D, 1)
    for (N, D, T) input,
  * std for 'wh' output features: per-channel std over time, then std of
    those stds over clips ("std of std"), + EPSILON,
  * std otherwise: a single scalar std over the whole array, broadcast.

Stats are persisted to `{exp}{pipeline}_preprocess_core.npz` by the
trainer and are part of the checkpoint contract (train_gan.py:183-185,
inference.py:81-87).
"""

from __future__ import annotations

import os

import numpy as np

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data.io import load_binary
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.constants import EPSILON


def mean_std(feat: str, data: np.ndarray, rot_idx) -> tuple[np.ndarray, np.ndarray]:
    """Reference: standardization_utils.py:51-59. `data` is (N, D, T)."""
    if feat == "wh":
        mean = data.mean(axis=2).mean(axis=0)[np.newaxis, :, np.newaxis]
        std = data.std(axis=2).std(axis=0)[np.newaxis, :, np.newaxis]
        std = std + EPSILON
    else:
        mean = data.mean(axis=2).mean(axis=0)[np.newaxis, :, np.newaxis]
        std = np.array([[[data.std()]]]).repeat(data.shape[1], axis=1)
    return mean, std


def calc_standard(train_X: np.ndarray, train_Y: np.ndarray, pipeline: str):
    """Reference: standardization_utils.py:37-47."""
    rot_idx = -6
    feats = pipeline.split("2")
    in_feat, out_feat = feats[0], feats[1]
    body_mean_X, body_std_X = mean_std(in_feat, train_X, rot_idx)
    if in_feat == out_feat:
        body_mean_Y = body_mean_X
        body_std_Y = body_std_X
    else:
        body_mean_Y, body_std_Y = mean_std(out_feat, train_Y, rot_idx)
    return body_mean_X, body_std_X, body_mean_Y, body_std_Y


def save_standardization(path, body_mean_X, body_std_X, body_mean_Y, body_std_Y):
    np.savez_compressed(
        path,
        body_mean_X=body_mean_X,
        body_std_X=body_std_X,
        body_mean_Y=body_mean_Y,
        body_std_Y=body_std_Y,
    )


def load_standardization(path):
    f = np.load(path)
    return (
        f["body_mean_X"],
        f["body_std_X"],
        f["body_mean_Y"],
        f["body_std_Y"],
    )


def compute_mean_std(clips_list_path: str, data_dir: str) -> np.ndarray:
    """Pixel mean/std over a list of (T, C, H, W, 2) crop arrays.

    Reference: standardization_utils.py:8-33 (unused on the main path but
    part of the video-crop pipeline).  Returns np.vstack((mean, std)) and
    writes `{data_dir}/mean_std.npy`.
    """
    clip_list = load_binary(os.path.join(data_dir, clips_list_path))
    psum = np.zeros(3)
    psum_sq = np.zeros(3)
    pixel_count = 0
    for clip in clip_list:
        psum += np.sum(clip[:, :, :, :, 0], axis=(0, 2, 3)) + np.sum(
            clip[:, :, :, :, 1], axis=(0, 2, 3)
        )
        psum_sq += np.sum(clip[:, :, :, :, 0].astype(np.float64) ** 2, axis=(0, 2, 3)) + np.sum(
            clip[:, :, :, :, 1].astype(np.float64) ** 2, axis=(0, 2, 3)
        )
        pixel_count += clip.shape[0] * clip.shape[2] * clip.shape[3] * clip.shape[4]
    total_mean = psum / pixel_count
    total_var = (psum_sq / pixel_count) - (total_mean**2)
    total_std = np.sqrt(total_var)
    out = np.vstack((total_mean, total_std))
    with open(os.path.join(data_dir, "mean_std.npy"), "wb") as f:
        np.save(f, out)
    return out
