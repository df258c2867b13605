"""Video ids; the part of the video featurizer that decodes nothing.

The port's copy of ``get_vid_ids`` from the JAX package's ``data/video.py``
(the re-design of the reference's proc_vid.py), which ``data/datasets``
needs for ``require_video_ids``.  Decoding, hand crops and the CNN features
are not ported yet (ROADMAP queue 1, item 4).
"""

from __future__ import annotations

import os


def get_vid_ids(vid_dir: str) -> list:
    """Ids of clips with an .mp4 present (proc_vid.py:66-68)."""
    return [x[:-4] for x in os.listdir(vid_dir) if x.endswith(".mp4")]
