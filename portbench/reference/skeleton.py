"""The 50-joint / 49-bone upper-body and hands tree of the reference's
3DposeEstimator/skeletalModel.py:42-126, as index arrays: bone i runs from
joint BONE_START[i] to BONE_END[i] (= i + 1), has length class
BONE_LENGTH_CLASS[i] (25 classes) and parent reference joint BONE_BEFORE[i].
A frozen copy for the plain reference."""

from __future__ import annotations

import numpy as np

# fmt: off
_STRUCTURE = (
    # head
    (0, 1, 0, -1),
    # right shoulder
    (1, 2, 1, 0),
    # right arm
    (2, 3, 2, 1),
    (3, 4, 3, 2),
    # left shoulder
    (1, 5, 1, 0),
    # left arm
    (5, 6, 2, 1),
    (6, 7, 3, 5),
    # right hand - wrist
    (4, 8, 4, 3),
    # right hand - 5 fingers x 4 bones
    (8, 9, 5, 4), (9, 10, 6, 8), (10, 11, 7, 9), (11, 12, 8, 10),
    (8, 13, 9, 4), (13, 14, 10, 8), (14, 15, 11, 13), (15, 16, 12, 14),
    (8, 17, 13, 4), (17, 18, 14, 8), (18, 19, 15, 17), (19, 20, 16, 18),
    (8, 21, 17, 4), (21, 22, 18, 8), (22, 23, 19, 21), (23, 24, 20, 22),
    (8, 25, 21, 4), (25, 26, 22, 8), (26, 27, 23, 25), (27, 28, 24, 26),
    # left hand - wrist
    (7, 29, 4, 6),
    # left hand - 5 fingers x 4 bones
    (29, 30, 5, 7), (30, 31, 6, 29), (31, 32, 7, 30), (32, 33, 8, 31),
    (29, 34, 9, 7), (34, 35, 10, 29), (35, 36, 11, 34), (36, 37, 12, 35),
    (29, 38, 13, 7), (38, 39, 14, 29), (39, 40, 15, 38), (40, 41, 16, 39),
    (29, 42, 17, 7), (42, 43, 18, 29), (43, 44, 19, 42), (44, 45, 20, 43),
    (29, 46, 21, 7), (46, 47, 22, 29), (47, 48, 23, 46), (48, 49, 24, 47),
)
# fmt: on

STRUCTURE = _STRUCTURE

# Static index arrays (int32) for gather-based kinematics.
BONE_START = np.array([b[0] for b in _STRUCTURE], dtype=np.int32)  # J
BONE_END = np.array([b[1] for b in _STRUCTURE], dtype=np.int32)  # E
BONE_LENGTH_CLASS = np.array([b[2] for b in _STRUCTURE], dtype=np.int32)  # L
BONE_BEFORE = np.array([b[3] for b in _STRUCTURE], dtype=np.int32)  # B

N_BONES = len(_STRUCTURE)  # 49
N_JOINTS = int(max(BONE_END.max(), BONE_START.max()) + 1)  # 50
N_LENGTH_CLASSES = int(BONE_LENGTH_CLASS.max() + 1)  # 25
