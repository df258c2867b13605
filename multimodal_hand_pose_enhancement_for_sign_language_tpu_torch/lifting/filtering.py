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
loop on a CPU tensor.  ``filter_xyz_matpow`` computes the same n steps in
closed form by batched (T, T) products; ``backpropagation_based_filtering_v2``
is the reference's single-clip API.
"""

from __future__ import annotations

import numpy as np
import torch

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.infer import (
    conv_matmul_precision,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops import skeleton
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops.filter_sgd import (
    filter_sgd,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.device import (
    resolve_device,
)

MATPOW_PRECISIONS = ("float32", "tensorfloat32", "bfloat16")


def fk_from_angles(lines, rootsx, rootsy, rootsz, anglesx, anglesy, anglesz):
    """Forward kinematics over the tree (pose3D.py:60-91):
    x[b] = x[a] + L * A / ||A||.

    lines (B, 25), roots (B, T, 1), angles (B, T, 49); returns (B, T, 50)
    x, y, z planes."""
    B, T, _ = rootsx.shape
    n = skeleton.N_JOINTS
    eps = 1e-10
    cls = torch.as_tensor(skeleton.BONE_LENGTH_CLASS, dtype=torch.int64,
                          device=lines.device)
    L_per_bone = torch.exp(lines[:, cls])  # (B, 49)

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
    Px[:, 0], Py[:, 0], Pz[:, 0] = rootsx[:, :, 0], rootsy[:, :, 0], rootsz[:, :, 0]
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


def filter_xyz_matpow(x0, y0, z0, tarx, tary, w, mask, learning_rate: float = 20.0,
                      n_cycles: int = 900, precision: str = "float32"):
    """The n-step SGD of ``filter_xyz`` in closed form, by batched products.

    The iteration is affine with fixed coefficients,

        x <- x - lr (W (x - tarx) + S x)  =  A x + b,
        A = I - lr (W + S),   b = lr W tarx,

    W = diag(2 w mask / (t_real J)) per (clip, joint), S the symmetric
    tridiagonal smoothness operator per clip, so

        x_n = A^n x0 + (I + A + ... + A^{n-1}) b,

    by affine square-and-multiply: floor(log2 n) squarings and popcount - 1
    composes of (B, J, T, T) operators, 12 products for n = 900.  x and y
    share one power chain with two offset vectors; z has no data term, so
    its A_z = I - lr S is one (B, T, T) chain for all joints, applied to z
    centred on its mean over the live steps.  The chain
    amplifies product rounding: ``precision`` 'float32' (TF32 off: the
    default) holds it within 3e-4 of the loop, 'tensorfloat32' runs the
    products at TF32, 'bfloat16' casts their operands to bfloat16.  Memory:
    each (B, 50, T, T) operand is B * 50 * T^2 * 4 bytes, so the engine
    refuses T > ``engine.MATPOW_MAX_T``.

    The JAX package's ``filter_xyz_matpow``; planes (B, T, J), mask (B, T);
    returns the filtered (x, y, z)."""
    if precision not in MATPOW_PRECISIONS:
        raise ValueError(f"precision {precision!r}: expected one of {MATPOW_PRECISIONS}")
    if n_cycles <= 0:  # the no-filter baseline, as the loop gives it
        return x0, y0, z0
    B, T, Jn = x0.shape
    dev, dtype = x0.device, x0.dtype
    t_real = mask.sum(dim=1)  # (B,)
    dd = t_real * Jn
    ds = (t_real - 1.0) * Jn

    # tridiagonal S per clip, scaled by lr / ds: (S x)_t = 2 d_t - 2 d_{t-1},
    # d_t = (x_t - x_{t+1}) pm_t, pm_t = mask_t mask_{t+1}
    pm = mask[:, :-1] * mask[:, 1:]  # (B, T-1)
    pad = torch.nn.functional.pad
    pm_r = pad(pm, (0, 1))  # pm_t
    pm_l = pad(pm, (1, 0))  # pm_{t-1}
    s_scale = (learning_rate / ds)[:, None]
    diag_s = 2.0 * (pm_r + pm_l) * s_scale  # (B, T)
    off_s = -2.0 * pm * s_scale  # (B, T-1), the super- and sub-diagonal
    eye = torch.eye(T, dtype=dtype, device=dev)
    sub = torch.diag(torch.ones(T - 1, dtype=dtype, device=dev), -1)  # (t, t-1)
    sup = torch.diag(torch.ones(T - 1, dtype=dtype, device=dev), 1)  # (t, t+1)
    off_r = pad(off_s, (0, 1))  # row t -> off_s[t]
    off_l = pad(off_s, (1, 0))  # row t -> off_s[t-1]
    A_z = (eye - diag_s[:, :, None] * eye - off_r[:, :, None] * sup
           - off_l[:, :, None] * sub)  # (B, T, T), shared by the joints

    # the data diagonal per (clip, joint), shared by x and y
    wdiag = ((2.0 * learning_rate / dd)[:, None, None] * (w * mask[:, :, None]))
    wdiag = wdiag.transpose(1, 2)  # (B, J, T)
    A_xy = A_z[:, None] - wdiag[..., None] * eye  # (B, J, T, T)
    b_x = wdiag * tarx.transpose(1, 2)  # (B, J, T)
    b_y = wdiag * tary.transpose(1, 2)

    if precision == "bfloat16":
        def matmul(a, b):
            return torch.matmul(a.bfloat16(), b.bfloat16()).to(dtype)
    else:
        matmul = torch.matmul

    def matvec(a, v):
        return matmul(a, v[..., None])[..., 0]

    def affine_pow(A, bs, n):
        """(P, qs): P = A^n, qs[i] = (I + A + ... + A^{n-1}) bs[i]."""
        Pr, qr = None, [None] * len(bs)  # the identity map
        Pb, qb = A, list(bs)
        while True:
            if n & 1:
                if Pr is None:
                    Pr, qr = Pb, list(qb)
                else:
                    qr = [matvec(Pb, q) + p for q, p in zip(qr, qb)]
                    Pr = matmul(Pb, Pr)
            n >>= 1
            if not n:
                break
            qb = [matvec(Pb, q) + q for q in qb]
            Pb = matmul(Pb, Pb)
        return Pr, qr

    with conv_matmul_precision("tensorfloat32" if precision == "tensorfloat32"
                               else "float32"):
        P_xy, (q_x, q_y) = affine_pow(A_xy, [b_x, b_y], n_cycles)
        del A_xy
        P_z, _ = affine_pow(A_z, [], n_cycles)
        x = (matvec(P_xy, x0.transpose(1, 2)) + q_x).transpose(1, 2)
        y = (matvec(P_xy, y0.transpose(1, 2)) + q_y).transpose(1, 2)
        # S kills constants, so P_z keeps each live run's mean: centred, the
        # chain's rounding scales with z's spread over the clip, not with
        # its size (lifted z reaches 14: uncentred, chip_smoke.py's 53 serving
        # clips of T <= 256 land 3.6e-4 from the loop on the CPU, centred
        # 8.8e-5).  Masked steps are identity rows and come out as z0.
        m = mask[:, :, None]
        mu = (z0 * m).sum(dim=1, keepdim=True) / m.sum(dim=1, keepdim=True).clamp(min=1.0)
        zc = ((z0 - mu) * m).transpose(1, 2)
        z = matvec(P_z[:, None], zc).transpose(1, 2) + mu * m + z0 * (1.0 - m)
    return x, y, z


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
