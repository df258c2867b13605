"""Backpropagation-based 3D filtering: FK snapshot, then direct xyz SGD.

PyTorch counterpart of the JAX package's ``lifting/filtering.py`` (the
reference's 3DposeEstimator/pose3D.py:10-109).  As in the reference, the
forward-kinematics result is snapshotted and the 900 SGD steps (lr=20)
move the xyz coordinates directly, minimising

    sum(w * ((x - tarx)^2 + (y - tary)^2)) / (T * nPoints)
    + sum(adjacent-frame squared diffs of x, y, z) / ((T-1) * nPoints)
    + sum(exp(lines))                        # constant in x, y, z

with the closed-form gradient.  ``filter_xyz`` runs it batched through
``ops/filter_sgd.filter_sgd``: the CUDA kernel on a CUDA tensor, the plain
loop on a CPU tensor; ``backpropagation_based_filtering_v2`` is the
reference's single-clip API.
"""

from __future__ import annotations

import numpy as np
import torch

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.lifting import init3d
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops import skeleton
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops.filter_sgd import (
    filter_sgd,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.device import (
    resolve_device,
)


def fk_from_angles(lines, rootsx, rootsy, rootsz, anglesx, anglesy, anglesz):
    """Forward kinematics over the tree (pose3D.py:60-91):
    x[b] = x[a] + L * A / ||A||.

    lines (B, 25), roots (B, T, 1), angles (B, T, 49); returns (B, T, 50)
    x, y, z planes."""
    return forward_kinematics(init3d.bone_lengths(lines), rootsx[:, :, 0],
                              rootsy[:, :, 0], rootsz[:, :, 0], anglesx, anglesy, anglesz)


def forward_kinematics(L_per_bone, rootsx, rootsy, rootsz, anglesx, anglesy, anglesz):
    """``fk_from_angles`` from per-bone lengths (B, 49) and (B, T) roots."""
    B, T = rootsx.shape
    n = skeleton.N_JOINTS
    eps = 1e-10
    normA = (
        torch.sqrt(anglesx * anglesx + anglesy * anglesy + anglesz * anglesz)
        + eps
    )
    Ux = (anglesx / normA).transpose(1, 2)  # (B, 49, T)
    Uy = (anglesy / normA).transpose(1, 2)
    Uz = (anglesz / normA).transpose(1, 2)

    Px = torch.zeros((B, n, T), dtype=rootsx.dtype, device=rootsx.device)
    Py = torch.zeros_like(Px)
    Pz = torch.zeros_like(Px)
    Px[:, 0], Py[:, 0], Pz[:, 0] = rootsx, rootsy, rootsz
    for i in range(skeleton.N_BONES):
        a, b = int(skeleton.BONE_START[i]), int(skeleton.BONE_END[i])
        L = L_per_bone[:, i : i + 1]
        Px[:, b] = Px[:, a] + L * Ux[:, i]
        Py[:, b] = Py[:, a] + L * Uy[:, i]
        Pz[:, b] = Pz[:, a] + L * Uz[:, i]
    return Px.transpose(1, 2), Py.transpose(1, 2), Pz.transpose(1, 2)


def filter_xyz(x0, y0, z0, tarx, tary, w, learning_rate: float = 20.0,
               n_cycles: int = 900, mask=None):
    """The SGD xyz smoothing (pose3D.py:93-109) on (B, T, nPoints) planes
    with a (B, T) frame mask (all frames valid when None), through
    ``filter_sgd``: the kernel on the card, the plain loop on the CPU."""
    if mask is None:
        mask = torch.ones(x0.shape[:2], dtype=x0.dtype, device=x0.device)
    return filter_sgd(x0, y0, z0, tarx, tary, w, mask, learning_rate, n_cycles)


def loss_value(x, y, z, tarx, tary, w, lines, mask=None):
    """The filtering loss per clip, (B,), including the constant
    sum(exp(lines)) term (pose3D.py:94-99)."""
    n_points = x.shape[2]
    if mask is None:
        mask = torch.ones(x.shape[:2], dtype=x.dtype, device=x.device)
    t_real = mask.sum(dim=1)
    wm = w * mask[:, :, None]
    data = (wm * ((x - tarx) ** 2 + (y - tary) ** 2)).sum(dim=(1, 2)) / (
        t_real * n_points
    )
    pm = (mask[:, :-1] * mask[:, 1:])[:, :, None]
    smooth = (
        pm * ((x[:, :-1] - x[:, 1:]) ** 2 + (y[:, :-1] - y[:, 1:]) ** 2
              + (z[:, :-1] - z[:, 1:]) ** 2)
    ).sum(dim=(1, 2)) / ((t_real - 1.0) * n_points)
    return data + smooth + torch.exp(lines).sum(dim=1)


def backpropagation_based_filtering_v2(lines0, rootsx0, rootsy0, rootsz0, anglesx0,
                                       anglesy0, anglesz0, tarx, tary, w, structure=None,
                                       dtype="float32", learningRate: float = 20.0,
                                       nCycles: int = 900, regulatorRates=None, mask=None,
                                       device="cuda"):
    """The reference's pose3D.backpropagationBasedFiltering_v2, same argument
    order, one clip: lines (25,), roots (T, 1), angles (T, 49), targets and
    weights (T, 50), mask (T,) or None; numpy arrays or tensors.  The FK
    snapshot, then the direct-xyz SGD through ``filter_xyz`` as a batch of
    one on ``device`` (the CUDA kernel there).  ``structure``, ``dtype`` and
    ``regulatorRates`` are the reference's and unused, as in the JAX
    package.  Returns the filtered (x, y, z), each (T, 50), on ``device``."""
    dev = resolve_device(device)

    def batch(a):
        return torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a,
                               dtype=torch.float32).to(dev)[None]

    x0, y0, z0 = fk_from_angles(*(batch(a) for a in (
        lines0, rootsx0, rootsy0, rootsz0, anglesx0, anglesy0, anglesz0)))
    x, y, z = filter_xyz(x0, y0, z0, batch(tarx), batch(tary), batch(w),
                         learning_rate=learningRate, n_cycles=nCycles,
                         mask=None if mask is None else batch(mask))
    return x[0], y[0], z[0]
