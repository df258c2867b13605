"""Window equalization, NaN filtering and pipeline slicing.

Reference behaviors reproduced exactly:
  * ``rmv_clips_nan``  — utils/postprocess_utils.py:5-28 (including the
    list-valued-Y variant and the single-index squeeze handling),
  * ``make_equal_len`` — utils/postprocess_utils.py:33-58; the only method
    used by the pipeline is "cutting+reflect" with maxpad=192.  The
    reference's "cutting" method crashes on `sizes % 2` (a list); here it
    implements the evident intent (documented divergence),
  * ``load_windows``   — utils/load_save_utils.py:37-58 (pipeline
    input/output block slicing, optional text/image feature attachment).
"""

from __future__ import annotations

import os

import numpy as np

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data.io import load_binary
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.constants import (
    FEATURE_MAP,
    WINDOW_T,
)


def nan_clip_indices(X, Y=None, T=None):
    """Sorted leading-axis indices that ``rmv_clips_nan`` would drop.

    Reference: postprocess_utils.py:5-28 (the index-computation half).
    """
    idx_nan = np.argwhere(np.isnan(X).any(axis=(1, 2))).squeeze().tolist()
    if isinstance(idx_nan, int):
        idx_nan = [idx_nan]
    if Y is not None:
        if isinstance(Y, list):
            idx_nan_Y = np.argwhere(np.isnan(Y)).squeeze().tolist()
        else:
            idx_nan_Y = np.argwhere(np.isnan(Y).any(axis=(1, 2))).squeeze().tolist()
        if isinstance(idx_nan_Y, int):
            idx_nan_Y = [idx_nan_Y]
        idx_nan += idx_nan_Y
    if T is not None:
        idx_nan_T = np.argwhere(np.isnan(T).any(axis=(1))).squeeze().tolist()
        if isinstance(idx_nan_T, int):
            idx_nan_T = [idx_nan_T]
        idx_nan += idx_nan_T
    return sorted(set(idx_nan))


def rmv_clips_nan(X, Y=None, T=None, idx_nan=None):
    """Drop clips (leading-axis entries) containing any NaN in X, Y or T.

    Reference: postprocess_utils.py:5-28.  ``idx_nan`` takes a
    precomputed ``nan_clip_indices`` result so callers that already need
    the indices (e.g. inference.py's selection bookkeeping) don't pay a
    second full-array isnan sweep.
    """
    if idx_nan is None:
        idx_nan = nan_clip_indices(X, Y, T)
    X = np.delete(X, idx_nan, axis=0)
    if Y is not None:
        Y = np.delete(Y, idx_nan, axis=0)
    if T is not None:
        T = np.delete(T, idx_nan, axis=0)
    return X, Y, T


def make_equal_len(data, pipeline="arm2wh", method="cutting+reflect", maxpad=WINDOW_T):
    """Equalize a list of (T_i, D) clips into a single (N, T, D) array.

    Reference: postprocess_utils.py:33-58.
    """
    sizes = [arr.shape[0] for arr in data]
    if method == "0pad":
        maxpad = np.amax(sizes) if maxpad == "maxlen" else maxpad
        maxpad = maxpad + 1 if maxpad % 2 == 1 else maxpad
        res = [
            np.vstack((arr, np.zeros((maxpad - arr.shape[0], arr.shape[1]), int)))
            for arr in data
        ]
        res = np.stack(res)

    elif method == "cutting":
        # NB: the reference computes `sizes % 2` on a Python list here
        # (postprocess_utils.py:44), which raises TypeError; this is the
        # evident intent: cut everything to the shortest even length.
        min_T = int(np.amin(sizes))
        min_T = min_T - 1 if min_T % 2 == 1 else min_T
        res = np.array([arr[:min_T, :] for arr in data])

    elif method == "cutting+0pad":
        res = np.array(
            [
                arr[:maxpad, :]
                if arr.shape[0] >= maxpad
                else np.vstack(
                    (arr, np.zeros((maxpad - arr.shape[0], arr.shape[1]), int))
                )
                for arr in data
            ]
        )

    elif method == "cutting+reflect":
        res = np.array(
            [
                arr[:maxpad, :]
                if arr.shape[0] >= maxpad
                else np.pad(arr, ((0, maxpad - arr.shape[0]), (0, 0)), "reflect")
                for arr in data
            ]
        )

    else:  # "wrap" or "reflect"
        max_T = np.amax(sizes) + 1 if np.amax(sizes) % 2 == 1 else np.amax(sizes)
        max_T = max(max_T, maxpad)
        res = [np.pad(arr, ((0, max_T - arr.shape[0]), (0, 0)), method) for arr in data]
        res = np.stack(res)
    return res


def pipeline_column_slices(pipeline):
    """(x_cols, y_cols) column slices of the raw window for a pipeline.

    Exactly the slicing rules of ``load_windows`` (reference
    load_save_utils.py:37-58) expressed as slices, so callers can fill
    preallocated X/Y blocks without materializing the full-width
    (N, T, 288) array first.
    """
    p0_size, p1_size = FEATURE_MAP[pipeline]
    if pipeline in ("arm_wh2wh", "wh2wh"):
        return slice(None), slice(6 * 6, None)
    if pipeline == "arm2wh" or pipeline[:13] == "arm_wh2finger":
        return slice(0, p0_size), slice(p0_size, p0_size + p1_size)
    raise KeyError(f"unknown pipeline {pipeline}")


def _window(arr, maxpad):
    """One clip's (or its per-frame features') cutting+reflect window."""
    if arr.shape[0] >= maxpad:
        return arr[:maxpad]
    return np.pad(arr, ((0, maxpad - arr.shape[0]), (0, 0)), "reflect")


def assemble_windows(data, x_cols, y_cols, check_cols, feats=None,
                     maxpad=WINDOW_T):
    """Fused cutting+reflect equalize + pipeline slice + NaN drop.

    Semantically identical to

        w = make_equal_len(data, method="cutting+reflect", maxpad=maxpad)
        X, Y = w[:, :, x_cols], w[:, :, y_cols]
        X, Y, feats = rmv_clips_nan(X, Y, feats)

    (per-frame features equalized by ``make_equal_len`` as well) but fills
    PREALLOCATED (N_kept, maxpad, ·) output arrays row by row instead of
    building a 31k-element list of padded copies and then np.array-ing it
    — on an overcommitted host, fresh transient pages are the bottleneck
    (STATUS.md round-3 diagnosis), so the final arrays are the only large
    allocations this path makes.

    ``check_cols`` must be the union of the X and Y column blocks (the
    caller asserts this via :func:`pipeline_column_slices`): cutting
    happens BEFORE the NaN check in the legacy path, so a clip is dropped
    iff its first ``maxpad`` frames contain a NaN in those columns.
    Reflect padding never introduces NaNs.  ``feats`` is optional, row for
    row with ``data``: per-clip vectors (sentence embeddings) are kept
    whole, per-frame (T_i, F) rows (image features) get the clips'
    cutting+reflect window; a clip whose vector, or whose features'
    window, holds a NaN is dropped.  (The reference's ``rmv_clips_nan``
    reads a NaN in per-frame features as (clip, column) pairs and either
    raises or drops the wrong clips; the drop here is its evident intent.)

    Returns (X, Y, feats_out, kept_indices).
    """
    dtypes = {arr.dtype for arr in data}
    dtype = np.result_type(*dtypes) if dtypes else np.float32
    rows = None if feats is None else [np.asarray(f) for f in feats]
    per_frame = bool(rows) and rows[0].ndim >= 2
    kept = []
    for i, arr in enumerate(data):
        if np.isnan(arr[:maxpad, check_cols]).any():
            continue
        if rows is not None and np.isnan(rows[i][:maxpad] if per_frame
                                         else rows[i]).any():
            continue
        kept.append(i)

    width = data[0].shape[1] if data else 0
    x_width = len(range(*x_cols.indices(width)))
    y_width = len(range(*y_cols.indices(width)))
    X = np.empty((len(kept), maxpad, x_width), dtype)
    Y = np.empty((len(kept), maxpad, y_width), dtype)
    F = None
    if per_frame:
        F = np.empty((len(kept), maxpad, *rows[0].shape[1:]),
                     np.result_type(*{r.dtype for r in rows}))
    for j, i in enumerate(kept):
        w = _window(data[i], maxpad)
        X[j] = w[:, x_cols]
        Y[j] = w[:, y_cols]
        if F is not None:
            F[j] = _window(rows[i], maxpad)
    if rows is not None and F is None:
        if isinstance(feats, np.ndarray):
            F = feats[np.asarray(kept, dtype=int)]
        else:
            F = np.asarray([rows[i] for i in kept])
    return X, Y, F, kept


def permute_rows_inplace(a, order):
    """In-place ``a[:] = a[order]`` (leading axis) via cycle-following.

    A fancy index allocates a full second copy of ``a``; this walks the
    permutation's cycles with a single row-sized buffer instead, so the
    article-scale shuffle touches no fresh pages.  ``order`` must be a
    permutation of ``range(len(a))``.
    """
    order = np.asarray(order)
    visited = np.zeros(len(order), dtype=bool)
    buf = np.empty_like(a[:1][0]) if len(a) else None
    for start in range(len(order)):
        if visited[start] or order[start] == start:
            visited[start] = True
            continue
        buf[...] = a[start]
        j = start
        while True:
            visited[j] = True
            k = int(order[j])
            if k == start:
                a[j] = buf
                break
            a[j] = a[k]
            j = k
    return a


def first_valid_window_indices(data, k, feats=None):
    """Indices of the first ``k`` clips whose 192-frame window (and
    feature row) would survive ``rmv_clips_nan`` downstream.

    Every pipeline's X/Y blocks jointly cover the full window width
    (FEATURE_MAP: p0+p1 == 288 or X spans all columns), so a whole-window
    NaN check is exactly the X-or-Y drop rule.  The window is
    ``arr[:WINDOW_T]``: clips at least WINDOW_T long are cut there, and
    shorter clips are reflect-padded, which cannot introduce NaNs.  Feats
    with a time axis (per-frame image features) are windowed the same way
    before the check; vector feats (sentence embeddings) are checked whole.

    Used to cap article-scale splits BEFORE the (N, T, D) equalize: when
    only ``num_samples`` windows are consumed (inference.py:96-123 caps
    there), materializing the other 90% of a 31k-clip split is pure
    host-memory churn.
    """
    idx = []
    for i, arr in enumerate(data):
        if np.isnan(arr[:WINDOW_T]).any():
            continue
        if feats is not None:
            f = np.asarray(feats[i], dtype=np.float32)
            if f.ndim >= 2:
                f = f[:WINDOW_T]
            if np.isnan(f).any():
                continue
        idx.append(i)
        if len(idx) >= k:
            break
    return idx


def load_windows(
    data_path,
    pipeline,
    require_text=False,
    text_path=None,
    require_image=False,
    image_path=None,
    require_audio=False,
    hand3d_image=False,
    use_lazy=False,
    test_smpl=False,
    temporal=False,
    num_samples=None,
    return_indices=False,
):
    """Load an r6d pickle, equalize to (N, 192, D) and slice input/output
    feature blocks according to the pipeline.

    Reference: load_save_utils.py:37-58.  Layout: arm block (36 cols)
    first, hands after; "wh2wh"/"arm_wh2wh" keep full X and slice Y at
    column 36; "arm2wh"/"arm_wh2fingerK" split at p0_size.
    """
    p0_size, p1_size = FEATURE_MAP[pipeline]
    if not os.path.exists(data_path):
        return None
    data = load_binary(data_path)
    feats = None
    if require_text and not require_image:
        feats = load_binary(text_path)
    elif require_image and not require_text:
        feats = load_binary(image_path)
    sel = list(range(len(data)))  # original clip index of each row
    if num_samples is not None and len(data) > num_samples:
        sel = first_valid_window_indices(data, num_samples, feats)
        data = [data[i] for i in sel]
        if feats is not None:
            if isinstance(feats, np.ndarray):
                feats = feats[np.asarray(sel, dtype=int)]
            else:
                feats = [feats[i] for i in sel]
    data = make_equal_len(data, method="cutting+reflect")
    if pipeline in ["arm_wh2wh", "wh2wh"]:
        p0_windows = data[:, :, :]
        p1_windows = data[:, :, 6 * 6 :]
    elif pipeline == "arm2wh" or pipeline[:13] == "arm_wh2finger":
        p0_windows = data[:, :, :p0_size]
        p1_windows = data[:, :, p0_size : p0_size + p1_size]
    else:
        raise KeyError(f"unknown pipeline {pipeline}")
    if require_text and not require_image:
        p0_windows = (p0_windows, feats)
    elif require_image and not require_text:
        feats = make_equal_len(feats, method="cutting+reflect")
        p0_windows = (p0_windows, feats)
    if return_indices:
        # original clip index of each returned row, BEFORE any downstream
        # rmv_clips_nan — consumers that persist per-window results use
        # this to subset aligned per-clip metadata (e.g. category labels)
        return p0_windows, p1_windows, sel
    return p0_windows, p1_windows
