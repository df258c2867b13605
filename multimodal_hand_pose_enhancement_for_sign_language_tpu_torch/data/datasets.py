"""Dataset assembly: the reference's load_H2S_dataset API.

The port's copy of the JAX package's ``data/datasets.py`` (library
equivalents of utils/utils.py:205-279 with paths as arguments; the reference
hard-codes cluster paths).  The CLI is ``process_dataset``.  The
``obtain_vid_*`` crop and feature drivers wait for the featurizer towers
(ROADMAP queue 1, item 4).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data import (
    categories as categ_lib,
    openpose,
    text as text_lib,
    video as video_lib,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.constants import (
    DATA_PATHS,
)


@dataclass
class DatasetPaths:
    """All external locations, overriding the reference's hard-coded
    cluster paths (proc_text.py:9-13, proc_vid.py:16-26, proc_categ.py:6-12)."""

    root: str
    text_template: str = "{split}.text.id.en"
    categ_template: str = "videoID_categoryID_{split}.csv"
    vid_template: str = "{split}/rgb_front/raw_videos"

    def json_dir(self, split):
        return os.path.join(self.root, DATA_PATHS[split])

    def _under_root(self, template, split):
        p = template.format(split=split)
        return p if os.path.isabs(p) else os.path.join(self.root, p)

    def text_path(self, split):
        return self._under_root(self.text_template, split)

    def categ_path(self, split):
        return self._under_root(self.categ_template, split)

    def vid_dir(self, split):
        return self._under_root(self.vid_template, split)


def _join_ids(dir_list, clip_ids):
    """Reference utils/utils.py:205-206."""
    return list(set(dir_list).intersection(clip_ids))


def _load_h2s_split(
    paths: DatasetPaths,
    split: str,
    group_by_clip: bool = True,
    subset: float = 1.0,
    text_method: str = "precomputed",
    require_video_ids: bool = False,
    max_workers=None,
):
    """One split -> (in_features, out_features, embeds, categs).

    Reference _load_H2S_dataset (utils/utils.py:214-261): id intersection
    across keypoints/text(/video), parallel utterance load, text
    embeddings, utterance->video grouping.
    """
    json_dir = paths.json_dir(split)
    ids = sorted(os.listdir(json_dir))
    text_path = paths.text_path(split)
    if os.path.exists(text_path):
        ids = _join_ids(ids, text_lib.get_clip_ids(text_path))
    if require_video_ids and os.path.isdir(paths.vid_dir(split)):
        ids = _join_ids(ids, video_lib.get_vid_ids(paths.vid_dir(split)))
    ids = sorted(ids)
    idx_max = int(len(ids) * subset)
    ids = ids[:idx_max]

    categs = None
    categ_path = paths.categ_path(split)
    if os.path.exists(categ_path):
        id_categ = categ_lib.get_ids_categ(categ_path)
        if group_by_clip:
            categs = [v for _, v in sorted(id_categ.items())]
        else:
            categs = categ_lib.get_clips_categ(ids, id_categ)
        # reference returns categs[:idx_max] (utils/utils.py:262)
        categs = categs[:idx_max]

    clips, in_features, out_features = openpose.load_utterances_parallel(
        ids, json_dir, max_workers=max_workers
    )
    embeds = None
    if os.path.exists(text_path) and text_method != "precomputed":
        embeds = text_lib.obtain_embeddings(
            text_path, ids, method=text_method, groupByClip=group_by_clip
        )
    if group_by_clip:
        clips, in_features, out_features = openpose.group_clips(
            clips, in_features, out_features
        )
    return in_features, out_features, embeds, categs


def load_h2s_dataset(paths: DatasetPaths, subset: float = 0.1, **kwargs):
    """All three splits (reference load_H2S_dataset, utils/utils.py:263-279)."""
    out = {}
    for split in ("test", "val", "train"):
        if os.path.isdir(paths.json_dir(split)):
            out[split] = _load_h2s_split(paths, split, subset=subset, **kwargs)
    return out


# camelCase alias for reference-API parity
load_H2S_dataset = load_h2s_dataset
