"""The 50-joint / 49-bone upper-body + hands kinematic tree.

Semantics match the reference tree (the reference's 3DposeEstimator/
skeletalModel.py:42-126): each bone is a tuple

    (J, E, L, B)

where J is the bone's start joint, E its end joint, L the bone-length-class
id (left/right symmetric parts share a class; 25 classes total) and B the
joint *before* J (reference point used to build rotation frames).  The tuple
order is topological (root -> leaves); in fact joints are numbered in bone
order so ``E_i == i + 1`` for every bone i — a property the TPU kinematics
code exploits for sequential `lax.scan` forward kinematics.

Unlike the reference (tuples consumed by Python loops), the tree is exposed
here as static NumPy index arrays so every consumer can gather with XLA ops.
"""

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

assert np.all(BONE_END == np.arange(1, N_BONES + 1)), (
    "kinematics code assumes joints are numbered in bone order (E_i == i+1)"
)


def get_skeletal_model_structure():
    """Return the tree as a tuple of (J, E, L, B) tuples (reference API)."""
    return _STRUCTURE


def structure_stats(structure=_STRUCTURE):
    """Number of (bone-length classes, joints) in a structure.

    Reference: skeletalModel.py:130-137.
    """
    points = set()
    classes = set()
    for a, b, l, *_ in structure:
        points.add(a)
        points.add(b)
        classes.add(l)
    return len(classes), len(points)


# camelCase aliases for drop-in compatibility with reference call sites.
getSkeletalModelStructure = get_skeletal_model_structure
structureStats = structure_stats
