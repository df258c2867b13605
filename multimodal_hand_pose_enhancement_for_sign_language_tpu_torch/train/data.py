"""Training data assembly: the load_data path of train_gan.py:129-205.

Loads r6d windows, drops NaN clips, computes and persists standardization
stats, standardizes, and shuffles with the reference's RandomState(23456).

Numpy only, on this package's own ``data/`` modules.  Float32 clips take
the preallocate-and-fill route (equalize, pipeline slice and NaN drop
fused, for the clips and their text or image features alike;
standardization and shuffle in place), whose only large allocations are
the final arrays.  Clips of any other dtype take the JAX package's legacy
chain (``load_windows``, ``rmv_clips_nan``, the statistics of a float32
copy, standardization computed in the clips' dtype and cast to float32),
which gives the same arrays as there.  With ``MHPE_LOAD_DATA_CACHE=1``
(``article_replay`` sets it for its run) the clip pickles are kept,
read-only, across calls (``_load_clips_cached``).

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


# The clip pickles kept across calls, by file identity, when
# MHPE_LOAD_DATA_CACHE=1: a caller that trains several configurations on
# the same splits loads each multi-GB pickle once.  The arrays are marked
# read-only, so a would-be mutation raises instead of changing what a later
# call reads.
_CLIPS_CACHE: dict = {}
_CLIPS_CACHE_MAX = 4  # the train and val pickles, with room


def _load_clips_cached(path: str):
    if os.environ.get("MHPE_LOAD_DATA_CACHE") != "1":
        return load_binary(path)
    st = os.stat(path)
    key = (os.path.realpath(path), st.st_mtime_ns, st.st_size)
    if key not in _CLIPS_CACHE:
        data = load_binary(path)
        if isinstance(data, list) and all(isinstance(a, np.ndarray) for a in data):
            for a in data:
                a.flags.writeable = False
        while len(_CLIPS_CACHE) >= _CLIPS_CACHE_MAX:
            _CLIPS_CACHE.pop(next(iter(_CLIPS_CACHE)))
        _CLIPS_CACHE[key] = data
    return _CLIPS_CACHE[key]


def clear_clips_cache() -> None:
    _CLIPS_CACHE.clear()


def _all_float32(data) -> bool:
    return all(isinstance(a, np.ndarray) and a.dtype == np.float32 for a in data)


def _fetch_split_legacy(path, data_dir, split, pipeline, require_text, require_image,
                        embeds_type):
    """The JAX package's legacy ``fetch_split`` + wh2wh slice +
    ``rmv_clips_nan``, for clips that are not float32."""
    if embeds_type == "normal":
        text_path = f"{data_dir}/{split}_sentence_embeddings.pkl"
    else:
        text_path = f"{data_dir}/average_{split}_sentence_embeddings.pkl"
    p0, p1 = win_lib.load_windows(
        path, pipeline, require_text=require_text, text_path=text_path,
        require_image=require_image, image_path=f"{data_dir}/{split}_vid_feats.pkl")
    feats = None
    if require_text or require_image:
        p0, feats = p0
    if pipeline == "wh2wh":
        p0 = p0[:, :, 6 * 6:]
    return win_lib.rmv_clips_nan(p0, p1, feats)


def fetch_split(data_dir: str, split: str, pipeline: str, require_text=False,
                require_image=False, embeds_type: str = "normal",
                base_path: str = "./"):
    """One split's r6d clips -> (X, Y, feats|None): windows of 192 frames,
    (N, T, D), the pipeline's column slices and the NaN drop in one pass
    over the clips (reference fetch_data :131-150 and the rmv_clips_nan
    that follows it).  Features come out row for row with X: per-clip text
    (N, 512), or per-frame image features cut+reflected like the clips,
    (N, T, 2000).  Clips that are not float32 take the legacy chain
    (``_fetch_split_legacy``), whose arrays keep the clips' dtype."""
    path = os.path.join(base_path, data_dir, DATA_PATHS_r6d[split])
    data = _load_clips_cached(path)
    if not _all_float32(data):
        return _fetch_split_legacy(path, data_dir, split, pipeline, require_text,
                                   require_image, embeds_type)
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
    write_stats=True,
):
    """Reference load_data (:129-205) in (N, T, D) layout.

    Returns dict with train_X/train_Y/val_X/val_Y as (N, T, D) float32,
    train_feats/val_feats (None without features; the training rows
    shuffled with the permutation of train_X), plus the standardization
    stats, and writes the stats to
    ``{model_path}/{exp_name}{pipeline}_preprocess_core.npz`` unless
    ``write_stats`` is False (the ranks but 0 of a multi-process run).
    """
    feat_args = (require_text, require_image, embeds_type, base_path)
    train_X, train_Y, train_feats = fetch_split(data_dir, "train", pipeline, *feat_args)
    val_X, val_Y, val_feats = fetch_split(data_dir, "val", pipeline, *feat_args)
    assert not np.any(np.isnan(train_X)) and not np.any(np.isnan(train_Y))
    assert not np.any(np.isnan(val_X)) and not np.any(np.isnan(val_Y))
    fused = all(a.dtype == np.float32 for a in (train_X, train_Y, val_X, val_Y))

    # stats are computed and persisted in the reference's (N, D, T)
    # layout.  numpy reductions over a swapaxes VIEW are bitwise-equal to
    # the same reductions over a contiguous copy; the legacy chain reduces
    # a float32 copy.
    tX = np.swapaxes(train_X, 1, 2)
    tY = np.swapaxes(train_Y, 1, 2)
    if not fused:
        tX, tY = tX.astype(np.float32), tY.astype(np.float32)
    mean_X, std_X, mean_Y, std_Y = std_lib.calc_standard(tX, tY, pipeline)
    del tX, tY
    if write_stats:
        mkdir(model_path)
        std_lib.save_standardization(
            os.path.join(model_path, f"{exp_name}{pipeline}_preprocess_core.npz"),
            mean_X,
            std_X,
            mean_Y,
            std_Y,
        )

    # standardize in (N, T, D): transpose the (1, D, 1) stats to (1, 1, D);
    # float32 arrays are subtracted and divided in place, the legacy chain's
    # are standardized in their dtype and cast
    mX, sX = mean_X.transpose(0, 2, 1), std_X.transpose(0, 2, 1)
    mY, sY = mean_Y.transpose(0, 2, 1), std_Y.transpose(0, 2, 1)
    if fused:
        for arr, m, s in ((train_X, mX, sX), (val_X, mX, sX),
                          (train_Y, mY, sY), (val_Y, mY, sY)):
            arr -= m
            arr /= s
    else:
        train_X = ((train_X - mX) / sX).astype(np.float32)
        val_X = ((val_X - mX) / sX).astype(np.float32)
        train_Y = ((train_Y - mY) / sY).astype(np.float32)
        val_Y = ((val_Y - mY) / sY).astype(np.float32)

    I = np.arange(len(train_X))
    rng.shuffle(I)
    if fused:
        win_lib.permute_rows_inplace(train_X, I)
        win_lib.permute_rows_inplace(train_Y, I)
        if train_feats is not None:
            win_lib.permute_rows_inplace(train_feats, I)
    else:
        train_X, train_Y = train_X[I], train_Y[I]
        if train_feats is not None:
            train_feats = train_feats[I]

    return dict(
        train_X=train_X,
        train_Y=train_Y,
        val_X=val_X,
        val_Y=val_Y,
        train_feats=train_feats,
        val_feats=val_feats,
        stats=(mean_X, std_X, mean_Y, std_Y),
    )
