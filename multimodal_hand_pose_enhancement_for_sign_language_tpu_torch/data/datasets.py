"""Dataset assembly: the reference's load_H2S_dataset API.

The port's copy of the JAX package's ``data/datasets.py`` (library
equivalents of utils/utils.py:205-279 with paths as arguments; the reference
hard-codes cluster paths).  The CLI is ``process_dataset``.  The
``obtain_vid_*`` functions write the hand crops and their ResNet-50 features
in chunks of clips, each chunk a pickle, concatenated in natural order.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data import (
    categories as categ_lib,
    openpose,
    text as text_lib,
    video as video_lib,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data.io import (
    load_binary,
    save_binary,
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
    device="cuda",
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
            text_path, ids, method=text_method, groupByClip=group_by_clip, device=device
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


def _video_ids(paths: DatasetPaths, split: str) -> list:
    """Ids with keypoints, text and an .mp4 (utils/utils.py:285-292)."""
    ids = _join_ids(os.listdir(paths.json_dir(split)),
                    text_lib.get_clip_ids(paths.text_path(split)))
    return sorted(_join_ids(ids, video_lib.get_vid_ids(paths.vid_dir(split))))


def _chunks(paths: DatasetPaths, split: str, chunk: int):
    """(start, crops) for each chunk of ``chunk`` clips, decoded (cv2) and
    cropped."""
    vid_dir = paths.vid_dir(split)
    ids = _video_ids(paths, split)
    for start in range(0, len(ids), chunk):
        sub = ids[start: start + chunk]
        clips = [video_lib.load_clip(os.path.join(vid_dir, i + ".mp4")) for i in sub]
        yield start, video_lib.obtain_cropped_clips(clips, paths.json_dir(split), sub)


def _gather(data_dir: str, pattern: str, remove: bool) -> list:
    files = glob.glob(os.path.join(data_dir, pattern))
    files.sort(key=openpose.natural_keys)  # chunk order, not lexicographic
    out = []
    for f in files:
        out += load_binary(f)
        if remove:
            os.remove(f)
    return out


def obtain_vid_crops(paths: DatasetPaths, split: str, data_dir: str, return_crops=False,
                     chunk=500):
    """Hand-crop extraction with chunked persistence
    (reference utils/utils.py:282-310); the chunk files are removed."""
    for start, crops in _chunks(paths, split, chunk):
        save_binary(crops, f"{data_dir}/{split}_vid_crops_{start}-{start + chunk}.pkl")
    crops = _gather(data_dir, f"{split}_vid_crops_*.pkl", remove=True)
    if return_crops:
        return crops
    save_binary(crops, f"{data_dir}/{split}_vid_crops.pkl")


def obtain_vid_feats(split: str, data_dir: str, hand_crops_list=None, weights_path=None,
                     device="cuda"):
    """Crops -> ResNet features pickle (reference utils/utils.py:314-319)."""
    if hand_crops_list is None:
        hand_crops_list = load_binary(f"{data_dir}/{split}_vid_crops.pkl")
    feats = video_lib.obtain_feats_crops_resnet(hand_crops_list, weights_path, device=device)
    save_binary(feats, f"{data_dir}/{split}_vid_feats.pkl")
    return feats


def obtain_vid_crops_and_feats(paths: DatasetPaths, split: str, data_dir: str,
                               weights_path=None, chunk=500, return_feats=False,
                               device="cuda"):
    """Crops and features in one pass, with chunked, naturally sorted
    persistence (reference utils/utils.py:322-356); the chunk files stay, as
    there."""
    for start, crops in _chunks(paths, split, chunk):
        feats = video_lib.obtain_feats_crops_resnet(crops, weights_path, device=device)
        save_binary(feats, f"{data_dir}/{split}_vid_feats_{start}-{start + chunk}.pkl")
    feats = _gather(data_dir, f"{split}_vid_feats_*.pkl", remove=False)
    if return_feats:
        return feats
    save_binary(feats, f"{data_dir}/{split}_vid_feats.pkl")
