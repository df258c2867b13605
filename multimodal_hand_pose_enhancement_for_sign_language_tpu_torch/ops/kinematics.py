"""Forward/inverse kinematics over the 49-bone tree.

PyTorch counterpart of the JAX package's ``ops/kinematics.py``:

  * ``clip_aa_to_xyz`` -- conversion_utils.py:117-137: rotate the parent
    direction by each bone's axis-angle (Rodrigues) and extend by the bone
    length; sequential over the 48 non-root bones, batched over clips and
    frames, with NO epsilon guards (as the reference),
  * ``clip_xyz_to_aa`` -- conversion_utils.py:140-155, per bone,
  * ``get_root_bone`` -- utils/utils.py:33-41,
  * ``get_bone_length`` -- 3DposeEstimator/pose3D.py:114-139 (mean length
    per bone index across all frames and clips, as the reference keys it).

xyz per frame: 50 joints x 3 = 150 floats, joint j at [3j, 3j+3); joints are
numbered in bone order, so bone i ends at joint i+1 (ops/skeleton.py).  aa
per frame: 48 bones x 3 = 144 floats, bone i (i >= 1) at [3(i-1), 3(i-1)+3).
"""

from __future__ import annotations

import numpy as np
import torch

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops import (
    batching,
    skeleton,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.device import (
    resolve_device,
)

N_JOINTS = skeleton.N_JOINTS
N_BONES = skeleton.N_BONES


def clip_aa_to_xyz(aa_clip, root, bone_len):
    """FK: (..., T, 144) aa + (6,) root + (49,) bone_len -> (..., T, 150).

    A degenerate parent direction or a zero rotation gives NaN, exactly like
    the reference (its rmv_clips_nan upstream handles it)."""
    lead = aa_clip.shape[:-1]
    aa = aa_clip.reshape(*lead, N_BONES - 1, 3)
    root = root.to(aa_clip.dtype)
    bone_len = bone_len.to(aa_clip.dtype)
    th = torch.sqrt((aa * aa).sum(dim=-1))  # (..., T, 48)
    k = aa / th[..., None]
    cos_t, sin_t = torch.cos(th), torch.sin(th)
    omc = 1.0 - cos_t

    P = [None] * N_JOINTS  # per joint: (..., T, 3)
    P[0] = root[0:3].expand(*lead, 3)
    P[1] = root[3:6].expand(*lead, 3)
    for i in range(1, N_BONES):
        j, e, b = (int(skeleton.BONE_START[i]), int(skeleton.BONE_END[i]),
                   int(skeleton.BONE_BEFORE[i]))
        pj = P[j]
        u = pj - P[b]
        ux, uy, uz = u.unbind(-1)
        un = torch.sqrt(ux * ux + uy * uy + uz * uz)
        ux, uy, uz = ux / un, uy / un, uz / un
        kx, ky, kz = k[..., i - 1, :].unbind(-1)
        c, s, o = cos_t[..., i - 1], sin_t[..., i - 1], omc[..., i - 1]
        # Rodrigues by components: v = u cos + (k x u) sin + k (k.u)(1-cos)
        dot = kx * ux + ky * uy + kz * uz
        vx = ux * c + (ky * uz - kz * uy) * s + kx * dot * o
        vy = uy * c + (kz * ux - kx * uz) * s + ky * dot * o
        vz = uz * c + (kx * uy - ky * ux) * s + kz * dot * o
        P[e] = pj + bone_len[i] * torch.stack((vx, vy, vz), dim=-1)
    return torch.stack(P, dim=-2).reshape(*lead, N_JOINTS * 3)


def clip_xyz_to_aa(xyz_clip):
    """IK: (..., T, 150) -> (..., T, 144).  theta is the angle between the
    parent direction u and the bone direction v (1e-6 in the cosine's
    denominator); axis = normalize(u x v) (+1e-6); aa = axis * theta."""
    lead = xyz_clip.shape[:-1]
    xyz = xyz_clip.reshape(*lead, N_JOINTS, 3)
    dev = xyz.device

    def joints(idx):
        return xyz.index_select(-2, torch.as_tensor(idx[1:], dtype=torch.int64,
                                                    device=dev))

    p_j = joints(skeleton.BONE_START)  # (..., T, 48, 3)
    p_b = joints(skeleton.BONE_BEFORE)
    p_e = joints(skeleton.BONE_END)
    u = p_j - p_b
    v = p_e - p_j

    def norm(a):
        return torch.sqrt((a * a).sum(dim=-1))

    dot = (u * v).sum(dim=-1)
    th = torch.arccos(dot / (norm(u) * norm(v) + 1e-6))
    a = torch.cross(u, v, dim=-1)
    a = a / (norm(a)[..., None] + 1e-6)
    return (a * th[..., None]).reshape(*lead, (N_BONES - 1) * 3)


def _as_clip_list(x):
    if isinstance(x, np.ndarray) and x.ndim == 3:
        return list(x)
    return x


def aa_to_xyz(aa, root, bone_len, device="cuda") -> list:
    """List-of-clips FK (conversion_utils.py:117-137)."""
    dev = resolve_device(device)
    root = torch.as_tensor(np.asarray(root, dtype=np.float32), device=dev)
    bone_len = torch.as_tensor(np.asarray(bone_len, dtype=np.float32), device=dev)
    return batching.apply_clipwise(
        clip_aa_to_xyz, _as_clip_list(aa), root, bone_len, device=dev
    )


def xyz_to_aa(xyz, device="cuda") -> list:
    """List-of-clips IK (conversion_utils.py:140-155)."""
    return batching.apply_clipwise(
        clip_xyz_to_aa, _as_clip_list(xyz), device=resolve_device(device)
    )


def get_root_bone(xyz) -> np.ndarray:
    """Mean (over all frames of all clips) of the root bone's two joints:
    a (6,) array [J0_xyz, E0_xyz] (utils/utils.py:33-41)."""
    clips = _as_clip_list(xyz)
    j0, e0 = int(skeleton.BONE_START[0]), int(skeleton.BONE_END[0])
    total = np.zeros(6, dtype=np.float64)
    count = 0
    for c in clips:
        c = np.asarray(c)
        pts = np.hstack((c[:, j0 * 3 : j0 * 3 + 3], c[:, e0 * 3 : e0 * 3 + 3]))
        total += pts.sum(axis=0)
        count += pts.shape[0]
    return (total / count).astype(np.float32)


def get_bone_length(kp_3d, dtype="float32") -> np.ndarray:
    """Mean length of each bone across all frames and clips, (49,) indexed
    by bone, not by bone-length class (pose3D.py:114-139)."""
    clips = _as_clip_list(kp_3d)
    sums = np.zeros(N_BONES, dtype=np.float64)
    counts = 0
    J = skeleton.BONE_START
    E = skeleton.BONE_END
    for c in clips:
        c = np.asarray(c)
        pts = c.reshape(c.shape[0], N_JOINTS, 3)
        d = pts[:, J, :] - pts[:, E, :]  # (T, 49, 3)
        lens = np.sqrt((d * d).sum(axis=-1))  # (T, 49)
        sums += lens.sum(axis=0)
        counts += lens.shape[0]
    return (sums / counts).astype(dtype)
