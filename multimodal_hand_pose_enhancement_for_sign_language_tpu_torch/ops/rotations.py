"""Rotation conversions: rot6d <-> matrix <-> axis-angle.

PyTorch counterpart of the JAX package's ``ops/rotations.py``, which
replaces the reference's utils/conversion_utils.py (scipy loops under
``Pool(24)``).  Everything is elementwise, with no 3x3 matmuls (a float32
product on the card may run at TF32):

  * rot6d -> matrix by Gram-Schmidt on the two encoded columns with the
    reference's 1e-6 norm epsilons (conversion_utils.py:86-107),
  * matrix -> quaternion by the Shepperd candidates, first maximum wins,
    sign canonicalized to w >= 0, then the atan2 log map (scipy
    ``as_rotvec``),
  * axis-angle -> the Rodrigues matrix, Taylor-guarded at 0.

The matrix forms (``rot6d_to_mat`` ... ``np_mat_to_rot6d``) take any
leading batch dims; the clip-level converters compute on separate scalar
planes, the same math.
"""

from __future__ import annotations

import numpy as np
import torch

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops import batching
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.device import (
    resolve_device,
)

_GS_EPS = 1e-6  # epsilon of the reference's Gram-Schmidt (:92, :94)


def _cross(a, b):
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack((a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0), dim=-1)


def _norm(a):
    return torch.sqrt((a * a).sum(dim=-1, keepdim=True))


def rot6d_to_mat(r6d):
    """(..., 6) -> (..., 3, 3) by Gram-Schmidt on the two encoded columns
    (conversion_utils.py:86-107): columns x = normalize(c0),
    z = normalize(x cross c1), y = z cross x."""
    x = r6d[..., 0:3] / (_norm(r6d[..., 0:3]) + _GS_EPS)
    z = _cross(x, r6d[..., 3:6])
    z = z / (_norm(z) + _GS_EPS)
    y = _cross(z, x)
    return torch.stack((x, y, z), dim=-1)


def mat_to_rot6d(mat):
    """(..., 3, 3) -> (..., 6): the first two columns
    (conversion_utils.py:12-29)."""
    return torch.cat((mat[..., :, 0], mat[..., :, 1]), dim=-1)


def aa_to_mat(aa):
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3):
    R = cos(t) I + sinc K + cosc k k^T, Taylor-guarded at t -> 0
    (scipy ``Rotation.from_rotvec``)."""
    theta2 = (aa * aa).sum(dim=-1, keepdim=True)[..., None]  # (..., 1, 1)
    theta = torch.sqrt(theta2)
    small = theta2 < 1e-12
    sinc = torch.where(small, 1.0 - theta2 / 6.0,
                       torch.sin(theta) / torch.where(small, 1.0, theta))
    cosc = torch.where(small, 0.5 - theta2 / 24.0,
                       (1.0 - torch.cos(theta)) / torch.where(small, 1.0, theta2))
    kx, ky, kz = aa.unbind(-1)
    zeros = torch.zeros_like(kx)
    K = torch.stack((
        torch.stack((zeros, -kz, ky), dim=-1),
        torch.stack((kz, zeros, -kx), dim=-1),
        torch.stack((-ky, kx, zeros), dim=-1),
    ), dim=-2)
    outer = aa[..., :, None] * aa[..., None, :]
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    cos_t = 1.0 - cosc * theta2  # cos(theta), exact on the small branch
    return cos_t * eye + sinc * K + cosc * outer


def mat_to_quat(mat):
    """(..., 3, 3) -> unit quaternion (..., 4) as (x, y, z, w), w >= 0: the
    best-conditioned of the four Shepperd candidates (first maximum), as
    scipy's ``Rotation.from_matrix`` up to the sign it canonicalizes."""
    m00, m01, m02 = mat[..., 0, 0], mat[..., 0, 1], mat[..., 0, 2]
    m10, m11, m12 = mat[..., 1, 0], mat[..., 1, 1], mat[..., 1, 2]
    m20, m21, m22 = mat[..., 2, 0], mat[..., 2, 1], mat[..., 2, 2]
    tr = m00 + m11 + m22
    # the candidates in (x, y, z, w), one per dominant term
    cand = torch.stack((
        torch.stack((m21 - m12, m02 - m20, m10 - m01, 1.0 + tr), dim=-1),
        torch.stack((1.0 + m00 - m11 - m22, m01 + m10, m02 + m20, m21 - m12), dim=-1),
        torch.stack((m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21, m02 - m20), dim=-1),
        torch.stack((m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22, m10 - m01), dim=-1),
    ), dim=-2)
    scores = torch.stack((1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
                          1.0 - m00 - m11 + m22), dim=-1)
    best = torch.argmax(scores, dim=-1)  # the first maximum
    q = torch.take_along_dim(cand, best[..., None, None].expand(*best.shape, 1, 4),
                             dim=-2)[..., 0, :]
    q = q / _norm(q)
    return q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)


def quat_to_aa(q):
    """Unit quaternion (x, y, z, w), w >= 0 -> rotation vector (..., 3)."""
    v = q[..., 0:3]
    n = _norm(v)[..., 0]
    angle = 2.0 * torch.atan2(n, q[..., 3])
    small = n < 1e-9
    scale = torch.where(small, 2.0, angle / torch.where(small, 1.0, n))
    return v * scale[..., None]


def mat_to_aa(mat):
    """(..., 3, 3) -> rotation vector (..., 3) (scipy ``as_rotvec``)."""
    return quat_to_aa(mat_to_quat(mat))


def aa_to_mat_rot6d(aa):
    """(..., 3) axis-angle -> (..., 6) rot6d."""
    return mat_to_rot6d(aa_to_mat(aa))


def rot6d_to_aa_vec(r6d):
    """(..., 6) rot6d -> (..., 3) axis-angle."""
    return mat_to_aa(rot6d_to_mat(r6d))


def _rot6d_to_aa_planes(a0, a1, a2, b0, b1, b2):
    """Component-plane r6d -> axis-angle: Gram-Schmidt + Shepperd
    candidates (first-max where-chain == argmax) + atan2 log map."""
    xn = torch.sqrt(a0 * a0 + a1 * a1 + a2 * a2) + _GS_EPS
    x0, x1, x2 = a0 / xn, a1 / xn, a2 / xn
    z0 = x1 * b2 - x2 * b1
    z1 = x2 * b0 - x0 * b2
    z2 = x0 * b1 - x1 * b0
    zn = torch.sqrt(z0 * z0 + z1 * z1 + z2 * z2) + _GS_EPS
    z0, z1, z2 = z0 / zn, z1 / zn, z2 / zn
    y0 = z1 * x2 - z2 * x1
    y1 = z2 * x0 - z0 * x2
    y2 = z0 * x1 - z1 * x0
    # rotation matrix with columns [x, y, z]
    m00, m01, m02 = x0, y0, z0
    m10, m11, m12 = x1, y1, z1
    m20, m21, m22 = x2, y2, z2
    tr = m00 + m11 + m22
    scores = (
        1.0 + tr,
        1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22,
        1.0 - m00 - m11 + m22,
    )
    cands = (
        (m21 - m12, m02 - m20, m10 - m01, scores[0]),
        (scores[1], m01 + m10, m02 + m20, m21 - m12),
        (m01 + m10, scores[2], m12 + m21, m02 - m20),
        (m02 + m20, m12 + m21, scores[3], m10 - m01),
    )
    best_s = scores[0]
    qx, qy, qz, qw = cands[0]
    for s, c in zip(scores[1:], cands[1:]):
        better = s > best_s  # strict: ties keep the earlier == first argmax
        best_s = torch.where(better, s, best_s)
        qx = torch.where(better, c[0], qx)
        qy = torch.where(better, c[1], qy)
        qz = torch.where(better, c[2], qz)
        qw = torch.where(better, c[3], qw)
    qn = torch.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    qx, qy, qz, qw = qx / qn, qy / qn, qz / qn, qw / qn
    sign = torch.where(qw < 0, -1.0, 1.0)
    qx, qy, qz, qw = qx * sign, qy * sign, qz * sign, qw * sign
    n = torch.sqrt(qx * qx + qy * qy + qz * qz)
    angle = 2.0 * torch.atan2(n, qw)
    small = n < 1e-9
    scale = torch.where(small, 2.0, angle / torch.where(small, 1.0, n))
    return qx * scale, qy * scale, qz * scale


def _aa_to_rot6d_planes(k0, k1, k2):
    """Component-plane axis-angle -> r6d: the first two Rodrigues columns
    (R = cos I + sinc K + cosc k k^T) directly, Taylor-guarded."""
    theta2 = k0 * k0 + k1 * k1 + k2 * k2
    small = theta2 < 1e-12
    theta = torch.sqrt(theta2)
    sinc = torch.where(
        small, 1.0 - theta2 / 6.0, torch.sin(theta) / torch.where(small, 1.0, theta)
    )
    cosc = torch.where(
        small,
        0.5 - theta2 / 24.0,
        (1.0 - torch.cos(theta)) / torch.where(small, 1.0, theta2),
    )
    cos_t = 1.0 - cosc * theta2
    r00 = cos_t + cosc * k0 * k0
    r10 = sinc * k2 + cosc * k1 * k0
    r20 = -sinc * k1 + cosc * k2 * k0
    r01 = -sinc * k2 + cosc * k0 * k1
    r11 = cos_t + cosc * k1 * k1
    r21 = sinc * k0 + cosc * k2 * k1
    return r00, r10, r20, r01, r11, r21


def clip_rot6d_to_aa(r6d):
    """(..., T, 6n) -> (..., T, 3n): per-bone rot6d blocks to axis-angle
    (conversion_utils.py:44-48)."""
    blocks = r6d.reshape(*r6d.shape[:-1], -1, 6)
    aa = _rot6d_to_aa_planes(*blocks.unbind(-1))
    return torch.stack(aa, dim=-1).reshape(*r6d.shape[:-1], -1)


def clip_aa_to_rot6d(aa):
    """(..., T, 3n) -> (..., T, 6n) (conversion_utils.py:72-81)."""
    blocks = aa.reshape(*aa.shape[:-1], -1, 3)
    r6d = _aa_to_rot6d_planes(*blocks.unbind(-1))
    return torch.stack(r6d, dim=-1).reshape(*aa.shape[:-1], -1)


def _as_clip_list(x):
    if isinstance(x, np.ndarray) and x.ndim == 3:
        return list(x)
    return x


def rot6d_to_aa(r6d, device="cuda") -> list:
    """List of (T_i, 6n) clips (or an (N, T, 6n) array) -> list of (T_i, 3n)
    (conversion_utils.py:51-56, the Pool(24) starmap as bucketed batches)."""
    return batching.apply_clipwise(
        clip_rot6d_to_aa, _as_clip_list(r6d), device=resolve_device(device)
    )


def aa_to_rot6d(aa, device="cuda") -> list:
    """List of (T_i, 3n) clips (or array) -> list of (T_i, 6n) clips
    (conversion_utils.py:72-81)."""
    return batching.apply_clipwise(
        clip_aa_to_rot6d, _as_clip_list(aa), device=resolve_device(device)
    )


# numpy in and out, the reference's names
def np_rot6d_to_mat(np_r6d):
    """(..., 6) -> (..., 9) flat rotation matrices (the reference's shape)."""
    np_r6d = np.asarray(np_r6d)
    shape = np_r6d.shape
    mat = rot6d_to_mat(torch.from_numpy(np.ascontiguousarray(np_r6d.reshape(-1, 6))))
    return mat.numpy().reshape(shape[:-1] + (9,))


def np_mat_to_rot6d(np_mat):
    """(..., 3, 3) or (..., 9) -> (..., 6) (the reference's shape; a (..., 3, 3)
    or (..., 9) batch comes back flat, (N, 6), as there)."""
    np_mat = np.asarray(np_mat)
    shape = np_mat.shape
    if not ((shape[-1] == 3 and shape[-2] == 3) or shape[-1] == 9):
        raise AttributeError(f"expected [..., 9] or [..., 3, 3], got shape {shape}")
    mat = torch.from_numpy(np.ascontiguousarray(np_mat.reshape(-1, 3, 3)))
    r6d = mat_to_rot6d(mat).numpy()
    return r6d.reshape(6) if len(shape) == 1 else r6d
