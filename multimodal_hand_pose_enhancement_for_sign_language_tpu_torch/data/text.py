"""Sentence loading and grouping; the model-free part of the text featurizer.

The port's copy of the JAX package's ``data/text.py`` (the re-design of the
reference's proc_text.py with paths as arguments): the `<id> <sentence>`
files, grouping utterances into videos, and the dataset-mean embedding.
``obtain_embeddings`` serves ``method="precomputed"`` (embeddings come from
pickles, the training and inference contract); the encoders (BERTsentence,
BERTword, clip) are not ported yet (ROADMAP queue 1, item 4).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data.openpose import (
    natural_keys,
)

NOT_PORTED = ("is not ported yet: the featurizer towers are ROADMAP queue 1, "
              "item 4")


def _group_by_clip(dict_text: dict) -> dict:
    """Concatenate utterance sentences per 11-char video id
    (proc_text.py:28-36)."""
    utterance_ids = sorted(dict_text.keys(), key=natural_keys)
    grouped: dict = {}
    for utt_id in utterance_ids:
        vid = utt_id[:11]
        if vid not in grouped:
            grouped[vid] = dict_text[utt_id].replace("\n", " ")
        else:
            grouped[vid] += dict_text[utt_id].replace("\n", " ")
    return grouped


def load_text(file_path: str, ids, groupByClip: bool = False) -> list:
    """Parse `<id> <sentence>` lines, keep requested ids, sort by id
    (proc_text.py:39-53)."""
    ids = set(ids)
    dict_text = {}
    with open(file_path) as fp:
        for line in fp:
            if not line.strip():
                continue
            utt_id, text = line.split(" ", 1)
            if utt_id in ids:
                dict_text[utt_id] = text
    if groupByClip:
        dict_text = _group_by_clip(dict_text)
    return [v for _, v in sorted(dict_text.items())]


def get_clip_ids(file_path: str) -> list:
    """Ids for which text is available (proc_text.py:104-111)."""
    id_list = []
    with open(file_path) as fp:
        for line in fp:
            if not line.strip():
                continue
            utt_id, _ = line.split(" ", 1)
            id_list.append(utt_id)
    return id_list


def obtain_embeddings(
    file_path: str,
    ids,
    method: str = "BERTsentence",
    groupByClip: bool = False,
    weights_path: Optional[str] = None,
) -> Optional[np.ndarray]:
    """Sentence embeddings for each clip (proc_text.py:57-100): None for
    ``"precomputed"``; the encoders raise ``NotImplementedError``."""
    if method == "precomputed":
        return None
    raise NotImplementedError(f"text embedding method {method!r} {NOT_PORTED}")


def average_embeds(embeds) -> np.ndarray:
    """The ``--embeds_type average`` pickle derived from per-clip embeddings:
    the dataset column mean tiled per clip (proc_text.py:133-139 re-runs the
    encoder for it; the mean over the same clip set is the same)."""
    embeds = np.asarray(embeds)
    return np.tile(np.average(embeds, axis=0), (embeds.shape[0], 1))
