"""Plain reference of the conversion from lifted xyz to the generator's
windows: inverse kinematics to axis-angle (conversion_utils.py:140-155),
axis-angle to the two first Rodrigues columns (r6d, conversion_utils.py:72-81),
and the 192-frame cutting+reflect window (postprocess_utils.py:33-58).
Plain torch and numpy, any dtype; each frame on its own.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import skeleton

WINDOW_T = 192


def xyz_to_aa(xyz):
    """(..., 150) -> (..., 144): for bone i >= 1, the angle between the
    parent direction u and the bone v (1e-6 under the cosine) about
    normalize(u x v) (+1e-6)."""
    lead = xyz.shape[:-1]
    p = xyz.reshape(*lead, skeleton.N_JOINTS, 3)

    def joints(idx):
        return p[..., torch.as_tensor(idx[1:], dtype=torch.int64, device=p.device), :]

    pj, pb, pe = (joints(a) for a in (skeleton.BONE_START, skeleton.BONE_BEFORE,
                                      skeleton.BONE_END))
    u, v = pj - pb, pe - pj

    def norm(a):
        return torch.sqrt((a * a).sum(dim=-1))

    th = torch.arccos((u * v).sum(dim=-1) / (norm(u) * norm(v) + 1e-6))
    a = torch.cross(u, v, dim=-1)
    a = a / (norm(a)[..., None] + 1e-6)
    return (a * th[..., None]).reshape(*lead, -1)


def aa_to_rot6d(aa):
    """(..., 3n) -> (..., 6n): R = cos I + sinc K + cosc k k^T, columns 0
    and 1 interleaved per bone, Taylor-guarded below theta^2 = 1e-12."""
    k = aa.reshape(*aa.shape[:-1], -1, 3)
    k0, k1, k2 = k.unbind(-1)
    t2 = k0 * k0 + k1 * k1 + k2 * k2
    small = t2 < 1e-12
    t = torch.sqrt(t2)
    sinc = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / torch.where(small, 1.0, t))
    cosc = torch.where(small, 0.5 - t2 / 24.0,
                       (1.0 - torch.cos(t)) / torch.where(small, 1.0, t2))
    c = 1.0 - cosc * t2
    cols = (c + cosc * k0 * k0, sinc * k2 + cosc * k1 * k0, -sinc * k1 + cosc * k2 * k0,
            -sinc * k2 + cosc * k0 * k1, c + cosc * k1 * k1, sinc * k0 + cosc * k2 * k1)
    return torch.stack(cols, dim=-1).reshape(*aa.shape[:-1], -1)


def window(clip, maxpad=WINDOW_T):
    """A (T, D) clip's window: its first ``maxpad`` frames, or the clip
    reflect-padded to ``maxpad``."""
    if clip.shape[0] >= maxpad:
        return clip[:maxpad]
    return np.pad(clip, ((0, maxpad - clip.shape[0]), (0, 0)), "reflect")


def xyz_to_windows(xyz_clips, device, dtype=torch.float64):
    """Lifted (T_i, 150) clips -> (N, 192, 288) r6d windows (numpy)."""
    out = []
    for c in xyz_clips:
        t = torch.as_tensor(np.asarray(c)).to(device, dtype)
        r6d = aa_to_rot6d(xyz_to_aa(t)).cpu()
        out.append(window((r6d.float() if r6d.dtype == torch.bfloat16 else r6d).numpy()))
    return np.stack(out)


def window_stack(clips, maxpad=WINDOW_T):
    """(T_i, D) clips -> (N, maxpad, D) windows."""
    return np.stack([window(np.asarray(c), maxpad) for c in clips])
