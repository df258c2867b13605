"""Classifier-side skeleton preprocessing for 26-joint body data.

The port's copy of the JAX package's ``data/skeleton_preproc.py`` (numpy
only; matplotlib is imported by ``plot_3D_skeleton`` alone, when called).
Re-design of H2Sclassifier/Preprocessing (rotate_skeleton.py, scale_axes.py,
skeleton_parts.py, plot_3D_skeleton.py) — a standalone utility pipeline
for an older 26-joint body format, disconnected from the B2H path (it
reads body_data.npy files produced elsewhere).  Vectorized over frames.

NB the reference's scale_axes indexes the frame axis with joint indices
(scale_axes.py:12-13: `xy_vec[bodypart_to_keypoint['Neck']]` on a
(T, J, 2) array) — this implements the evident intent: per-frame torso
length normalization.
"""

from __future__ import annotations

import numpy as np

keypoint_to_bodypart = {
    0: "Neck", 1: "Nose", 2: "MidHip",
    3: "LShoulder", 4: "LElbow", 5: "LHand",
    6: "LHip", 7: "LKnee", 8: "LAnkle",
    9: "RShoulder", 10: "RElbow", 11: "RHand",
    12: "RHip", 13: "RKnee", 14: "RAnkle",
    15: "LEye", 16: "LEar", 17: "REye", 18: "REar",
    19: "LBigToe", 20: "LSmallToe", 21: "LHeel",
    22: "RBigToe", 23: "RSmallToe", 24: "RHeel",
}
bodypart_to_keypoint = {v: k for k, v in keypoint_to_bodypart.items()}

_parts = {
    "RightArm": ["Neck", "RShoulder", "RElbow", "RHand"],
    "LeftArm": ["Neck", "LShoulder", "LElbow", "LHand"],
    "Column": ["Nose", "Neck", "MidHip"],
    "RightLeg": ["MidHip", "RHip", "RKnee", "RAnkle"],
    "LeftLeg": ["MidHip", "LHip", "LKnee", "LAnkle"],
    "RightFace": ["Nose", "REye", "REar"],
    "LeftFace": ["Nose", "LEye", "LEar"],
    "RightFoot": ["RAnkle", "RHeel", "RBigToe", "RSmallToe"],
    "LeftFoot": ["LAnkle", "LHeel", "LBigToe", "LSmallToe"],
}
skeleton_parts = [
    [bodypart_to_keypoint[k] for k in names] for names in _parts.values()
]


def _rotvec_apply(rotvec, pts):
    """Apply an axis-angle rotation to (J, 3) points (Rodrigues)."""
    th = np.linalg.norm(rotvec)
    if th < 1e-12:
        return pts
    k = rotvec / th
    return (
        pts * np.cos(th)
        + np.cross(k, pts) * np.sin(th)
        + np.outer(pts @ k, k) * (1 - np.cos(th))
    )


def rotate_skeleton(vec_xyz: np.ndarray) -> np.ndarray:
    """One frame (J, 3): translate mid-hip to origin, align the spine with
    +y, then face the skeleton along +x (rotate_skeleton.py:8-39)."""
    mid_hip = vec_xyz[bodypart_to_keypoint["MidHip"]]
    pts = vec_xyz - mid_hip

    column = vec_xyz[bodypart_to_keypoint["Neck"]] - mid_hip
    column = column / np.linalg.norm(column)
    y_vec = np.array([0.0, 1.0, 0.0])
    y_angle = np.arccos(np.clip(np.dot(column, y_vec), -1, 1))
    normal = np.cross(column, y_vec)
    normal = normal / np.linalg.norm(normal)
    pts = _rotvec_apply(y_angle * normal, pts)

    face = pts[bodypart_to_keypoint["Nose"]] - pts[bodypart_to_keypoint["Neck"]]
    face = face / np.linalg.norm(face)
    face_proj = np.array([face[0], 0.0, face[2]])
    face_proj = face_proj / np.linalg.norm(face_proj)
    x_vec = np.array([1.0, 0.0, 0.0])
    x_angle = np.arccos(np.clip(np.dot(face_proj, x_vec), -1, 1))
    normal = np.cross(face_proj, x_vec)
    normal = normal / np.linalg.norm(normal)
    return _rotvec_apply(x_angle * normal, pts)


def rotate_clip(xyz: np.ndarray) -> np.ndarray:
    """(T, J, 3) -> per-frame rotated."""
    return np.stack([rotate_skeleton(f) for f in xyz])


def scale_axes(xyz_vec: np.ndarray) -> np.ndarray:
    """(T, J, 3): divide all coordinates by the per-frame 2D torso
    (Neck-MidHip) length (scale_axes.py intent)."""
    neck = xyz_vec[:, bodypart_to_keypoint["Neck"], 0:2]
    hip = xyz_vec[:, bodypart_to_keypoint["MidHip"], 0:2]
    torso_len = np.linalg.norm(neck - hip, axis=1)  # (T,)
    return xyz_vec / torso_len[:, None, None]


def plot_3D_skeleton(frame_xyz: np.ndarray, out_path: str = "skeleton.png"):
    """Render one (J, 3) frame with the body-part line groups
    (plot_3D_skeleton.py)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure()
    ax = plt.axes(projection="3d")
    for part in skeleton_parts:
        pts = frame_xyz[part]
        ax.plot(pts[:, 0], pts[:, 1], pts[:, 2])
    fig.savefig(out_path, dpi=75)
    plt.close(fig)
    return out_path
