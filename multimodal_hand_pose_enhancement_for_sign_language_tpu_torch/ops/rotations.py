"""Rotation conversions on the per-frame block layout: rot6d <-> axis-angle.

PyTorch counterpart of the plane-form half of the JAX package's
``ops/rotations.py`` (:166-284), which replaces the reference's
utils/conversion_utils.py (scipy loops under ``Pool(24)``).  The math works
on separate scalar planes, elementwise, with no 3x3 matmuls:

  * rot6d -> matrix by Gram-Schmidt on the two encoded columns with the
    reference's 1e-6 norm epsilons (conversion_utils.py:86-107),
  * matrix -> quaternion by the Shepperd candidates, first maximum wins,
    sign canonicalized to w >= 0, then the atan2 log map (scipy
    ``as_rotvec``),
  * axis-angle -> the first two Rodrigues columns, Taylor-guarded at 0.
"""

from __future__ import annotations

import numpy as np
import torch

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops import batching
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.device import (
    resolve_device,
)

_GS_EPS = 1e-6  # epsilon of the reference's Gram-Schmidt (:92, :94)


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
