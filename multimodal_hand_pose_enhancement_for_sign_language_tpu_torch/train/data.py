"""Training data assembly: the load_data path of train_gan.py:129-205.

Loads r6d windows, drops NaN clips, computes and persists standardization
stats, standardizes, and shuffles with the reference's RandomState(23456).

Numpy only, on this package's own ``data/`` modules.  It keeps one way of
assembling a split: the preallocate-and-fill one (equalize, pipeline slice
and NaN drop fused, for the clips and their text or image features alike;
standardization and shuffle in place), whose only large allocations are
the final arrays.  The clips must be float32; anything else raises.

Layout note: the reference trains in (N, D, T).  Arrays are returned as
(N, T, D), the layout of this package's public functions (the trainer and
``run_inference`` transpose a batch on the device), and the persisted
standardization npz keeps the reference's (1, D, 1) shape contract so
stats files remain interchangeable.
"""

from __future__ import annotations

import os

import numpy as np

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data import (
    standardize as std_lib,
    windows as win_lib,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data.io import (
    load_binary,
    mkdir,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.constants import (
    DATA_PATHS_r6d,
)


def _feature_path(data_dir, split, require_text, require_image, embeds_type):
    """The split's feature pickle, or None.  As the JAX package's
    load_windows does, both flags together load none."""
    if require_text and not require_image:
        if embeds_type == "normal":
            return f"{data_dir}/{split}_sentence_embeddings.pkl"
        return f"{data_dir}/average_{split}_sentence_embeddings.pkl"
    if require_image and not require_text:
        return f"{data_dir}/{split}_vid_feats.pkl"
    return None


def fetch_split(data_dir: str, split: str, pipeline: str, require_text=False,
                require_image=False, embeds_type: str = "normal",
                base_path: str = "./"):
    """One split's r6d clips -> (X, Y, feats|None): windows of 192 frames,
    (N, T, D), the pipeline's column slices and the NaN drop in one pass
    over the clips (reference fetch_data :131-150 and the rmv_clips_nan
    that follows it).  Features come out row for row with X: per-clip text
    (N, 512), or per-frame image features cut+reflected like the clips,
    (N, T, 2000)."""
    path = os.path.join(base_path, data_dir, DATA_PATHS_r6d[split])
    data = load_binary(path)
    if not all(
        isinstance(arr, np.ndarray) and arr.dtype == np.float32 for arr in data
    ):
        raise ValueError(f"{path}: the clips must be float32 numpy arrays")
    feats_path = _feature_path(data_dir, split, require_text, require_image,
                               embeds_type)
    feats = load_binary(feats_path) if feats_path else None
    x_cols, y_cols = win_lib.pipeline_column_slices(pipeline)
    if pipeline == "wh2wh":
        # the reference slices X to [36:] BEFORE the NaN check, so NaNs
        # confined to the arm block must NOT drop a clip
        x_cols = slice(6 * 6, None)
        check_cols = slice(6 * 6, None)
    else:
        width = data[0].shape[1] if data else 0
        covered = set(range(*x_cols.indices(width))) | set(
            range(*y_cols.indices(width))
        )
        assert covered == set(range(width)), (pipeline, x_cols, y_cols)
        check_cols = slice(None)
    X, Y, feats, _ = win_lib.assemble_windows(data, x_cols, y_cols, check_cols,
                                              feats=feats)
    return X, Y, feats


def load_data(
    data_dir: str,
    pipeline: str,
    model_path: str,
    exp_name: str,
    rng: np.random.RandomState,
    require_text=False,
    require_image=False,
    embeds_type="normal",
    base_path="./",
):
    """Reference load_data (:129-205) in (N, T, D) layout.

    Returns dict with train_X/train_Y/val_X/val_Y as (N, T, D) float32,
    train_feats/val_feats (None without features; the training rows
    shuffled with the permutation of train_X), plus the standardization
    stats, and writes the stats to
    ``{model_path}/{exp_name}{pipeline}_preprocess_core.npz``.
    """
    feat_args = (require_text, require_image, embeds_type, base_path)
    train_X, train_Y, train_feats = fetch_split(data_dir, "train", pipeline, *feat_args)
    val_X, val_Y, val_feats = fetch_split(data_dir, "val", pipeline, *feat_args)
    assert not np.any(np.isnan(train_X)) and not np.any(np.isnan(train_Y))
    assert not np.any(np.isnan(val_X)) and not np.any(np.isnan(val_Y))

    # stats are computed and persisted in the reference's (N, D, T)
    # layout.  numpy reductions over a swapaxes VIEW are bitwise-equal to
    # the same reductions over a contiguous copy.
    tX = np.swapaxes(train_X, 1, 2)
    tY = np.swapaxes(train_Y, 1, 2)
    mean_X, std_X, mean_Y, std_Y = std_lib.calc_standard(tX, tY, pipeline)
    del tX, tY
    mkdir(model_path)
    std_lib.save_standardization(
        os.path.join(model_path, f"{exp_name}{pipeline}_preprocess_core.npz"),
        mean_X,
        std_X,
        mean_Y,
        std_Y,
    )

    # standardize in (N, T, D): transpose the (1, D, 1) stats to (1, 1, D);
    # all float32 by construction, so subtract and divide in place
    mX, sX = mean_X.transpose(0, 2, 1), std_X.transpose(0, 2, 1)
    mY, sY = mean_Y.transpose(0, 2, 1), std_Y.transpose(0, 2, 1)
    for arr, m, s in ((train_X, mX, sX), (val_X, mX, sX),
                      (train_Y, mY, sY), (val_Y, mY, sY)):
        arr -= m
        arr /= s

    I = np.arange(len(train_X))
    rng.shuffle(I)
    win_lib.permute_rows_inplace(train_X, I)
    win_lib.permute_rows_inplace(train_Y, I)
    if train_feats is not None:
        win_lib.permute_rows_inplace(train_feats, I)

    return dict(
        train_X=train_X,
        train_Y=train_Y,
        val_X=val_X,
        val_Y=val_Y,
        train_feats=train_feats,
        val_feats=val_feats,
        stats=(mean_X, std_X, mean_Y, std_Y),
    )
