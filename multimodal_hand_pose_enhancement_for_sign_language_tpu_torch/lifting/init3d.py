"""Initial 3D pose estimate: bone-length medians, the closed-form angle
hypotheses (computeB) and forward accumulation over the 49-bone tree.

PyTorch counterpart of the JAX package's ``lifting/init3d.py`` (the
reference's 3DposeEstimator/pose2Dto3D.py:33-159), batched over clips:
planes are (B, T, n), the bone loop is a Python loop over the 49 bones on
(B, T) tensors, and every frame is solved in parallel.  The hypothesis
selection keeps the reference's first-minimum rule and all of its nan/inf
guards.
"""

from __future__ import annotations

import numpy as np
import torch

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops import skeleton

_EPS = 1e-10


def add_noise(x, rng, epsilon):
    """Uniform noise in [-epsilon, epsilon) from a NumPy RandomState, drawn
    in float64 and cast to float32 (pose2Dto3D.py:12-14); ``x`` is a numpy
    array or a tensor (the noise goes to its device)."""
    e = np.asarray(rng.uniform(low=-epsilon, high=epsilon, size=tuple(x.shape)), "float32")
    if isinstance(x, torch.Tensor):
        return x + torch.from_numpy(e).to(x.device)
    return x + e


def bone_length_classes(Xx, Xy, mask=None):
    """Log median 2D length per bone-length class, (B, 25)
    (pose2Dto3D.py:100-116).

    Lengths pool over every frame of every bone of a class; the median is
    the reference's ``sorted[int(0.5 * (len - 1))]``.  Padded frames sort to
    +inf and each clip indexes with its own real count (a gather, since the
    count differs per clip).
    """
    B, T, _ = Xx.shape
    J, E = skeleton.BONE_START, skeleton.BONE_END
    dx = Xx[:, :, J] - Xx[:, :, E]  # (B, T, 49)
    dy = Xy[:, :, J] - Xy[:, :, E]
    L = torch.sqrt(dx * dx + dy * dy)
    if mask is None:
        t_real = torch.full((B,), T, dtype=torch.int32, device=Xx.device)
        Lm = L
    else:
        t_real = mask.sum(dim=1).to(torch.int32)
        Lm = torch.where(mask[:, :, None] > 0, L, torch.full_like(L, torch.inf))

    lines = []
    for c in range(skeleton.N_LENGTH_CLASSES):
        members = np.nonzero(skeleton.BONE_LENGTH_CLASS == c)[0]
        pool = Lm[:, :, members].reshape(B, -1)
        pool = torch.sort(pool, dim=1).values
        n_valid = (t_real * len(members)).to(torch.float32)
        idx = (0.5 * (n_valid - 1)).to(torch.int64)  # truncates toward 0
        lines.append(torch.log(pool.gather(1, idx[:, None])[:, 0] + 1e-9))
    return torch.stack(lines, dim=1).to(Xx.dtype)


def compute_b(ax, ay, az, tx, ty, L):
    """Closed-form angle hypothesis solve, elementwise.  Returns the winning
    (bx, by, bz), each shaped like ``ax``.

    Transcribes pose2Dto3D.py:33-65: up to five hypotheses per frame; the
    first minimum of the 2D reprojection error wins (strict ``<``, so ties
    keep the earlier hypothesis)."""
    dx = tx - ax
    dy = ty - ay
    # h0: in-plane direction
    foo = L**2 - dx**2 - dy**2
    sq = torch.sqrt(torch.clamp(foo, min=0.0))
    foo1 = ax**2 - 2 * ax * tx + ay**2 - 2 * ay * ty + tx**2 + ty**2
    foo2 = (1.0 / foo1) ** 0.5
    common = (
        ay**3 / foo1
        + (ax**2 * ay) / foo1
        + (ay * tx**2) / foo1
        + (ay * ty**2) / foo1
        - (2 * ay**2 * ty) / foo1
        - (2 * ax * ay * tx) / foo1
    )
    foo3 = common + L * ay * foo2 - L * ty * foo2
    foo4 = common - L * ay * foo2 + L * ty * foo2
    xx1 = -(ax * ty - ay * tx - ax * foo3 + tx * foo3) / (ay - ty)
    xx2 = -(ax * ty - ay * tx - ax * foo4 + tx * foo4) / (ay - ty)
    xy1 = foo3
    xy2 = foo4

    zeros = torch.zeros_like(dx)
    finite34 = torch.isfinite(0.0 * xx1 * xx2 * xy1 * xy2)
    candidates = [
        (dx, dy, zeros, torch.ones_like(dx, dtype=torch.bool)),
        (dx, dy, -sq, foo >= 0),
        (dx, dy, sq, foo >= 0),
        (xx1 - ax, xy1 - ay, zeros, finite34),
        (xx2 - ax, xy2 - ay, zeros, finite34),
    ]

    def reproj_err(hx, hy, hz):
        norm_h = torch.sqrt(hx * hx + hy * hy + hz * hz) + _EPS
        xi_x = ax + L * hx / norm_h
        xi_y = ay + L * hy / norm_h
        return (xi_x - tx) ** 2 + (xi_y - ty) ** 2

    inf = torch.full_like(dx, torch.inf)
    h0x, h0y, h0z, _ = candidates[0]
    L0_raw = reproj_err(h0x, h0y, h0z)
    best_l = torch.where(torch.isfinite(L0_raw), L0_raw, inf)
    bx, by, bz = h0x, h0y, h0z
    for hx, hy, hz, valid in candidates[1:]:
        li_raw = reproj_err(hx, hy, hz)
        li = torch.where(valid & torch.isfinite(li_raw), li_raw, inf)
        better = li < best_l  # strict: ties keep the earlier hypothesis
        best_l = torch.where(better, li, best_l)
        bx = torch.where(better, hx, bx)
        by = torch.where(better, hy, by)
        bz = torch.where(better, hz, bz)
    # reference quirk (pose2Dto3D.py:52-64): the first hypothesis is always
    # assigned and a NaN minimum is never displaced, so a non-finite h0
    # error keeps h0 whatever the later hypotheses give
    keep0 = ~torch.isfinite(L0_raw)
    bx = torch.where(keep0, h0x, bx)
    by = torch.where(keep0, h0y, by)
    bz = torch.where(keep0, h0z, bz)
    return bx, by, bz


def initialization(Xx, Xy, Xw, sigma=0.001, noise=None, rng=None, dtype="float32",
                   mask=None):
    """Initial 3D estimate (pose2Dto3D.py:73-159) for (B, T, n) planes.

    ``noise``: optional (B, 3, T) uniform root noise (the reference's
    per-clip RandomState(1234) draws, see ``engine._clip_noise``);
    otherwise, with a ``torch.Generator`` ``rng`` on the planes' device,
    U(-sigma, sigma) draws for the roots' x, y and z, in that order, each
    (B, T); with neither, no noise.  ``dtype`` is the reference's argument,
    accepted for its signature: the planes' dtype decides, as in the JAX
    package.

    Returns (lines (B, 25), rootsx, rootsy, rootsz (B, T, 1), anglesx,
    anglesy, anglesz (B, T, 49), Yx, Yy, Yz (B, T, n)).
    """
    B, T, n = Xx.shape
    lines = bone_length_classes(Xx, Xy, mask=mask)
    cls = torch.as_tensor(skeleton.BONE_LENGTH_CLASS, dtype=torch.int64,
                          device=Xx.device)
    L_per_bone = torch.exp(lines[:, cls])  # (B, 49)

    rootsx = Xx[:, :, 0]
    rootsy = Xy[:, :, 0]
    rootsz = torch.zeros((B, T), dtype=Xx.dtype, device=Xx.device)
    if noise is not None:
        rootsx = rootsx + noise[:, 0]
        rootsy = rootsy + noise[:, 1]
        rootsz = rootsz + noise[:, 2]
    elif rng is not None:
        def draw():
            u = torch.rand((B, T), generator=rng, dtype=Xx.dtype, device=Xx.device)
            return u * (2 * sigma) - sigma

        rootsx = rootsx + draw()
        rootsy = rootsy + draw()
        rootsz = rootsz + draw()

    # joint-major (B, n, T) planes: each bone step reads and writes rows
    XxT = Xx.transpose(1, 2)
    XyT = Xy.transpose(1, 2)
    Yx = torch.zeros((B, n, T), dtype=Xx.dtype, device=Xx.device)
    Yy = torch.zeros_like(Yx)
    Yz = torch.zeros_like(Yx)
    Yx[:, 0], Yy[:, 0], Yz[:, 0] = rootsx, rootsy, rootsz

    gxs, gys, gzs = [], [], []
    for i in range(skeleton.N_BONES):
        a, b = int(skeleton.BONE_START[i]), int(skeleton.BONE_END[i])
        L = L_per_bone[:, i : i + 1]  # (B, 1)
        ax, ay, az = Yx[:, a], Yy[:, a], Yz[:, a]
        gx, gy, gz = compute_b(ax, ay, az, XxT[:, b], XyT[:, b], L)
        # nan/inf guards (pose2Dto3D.py:130-143)
        zero = torch.zeros_like(gx)
        gx = torch.where(torch.isfinite(gx), gx, zero)
        gy = torch.where(torch.isfinite(gy), gy, zero)
        gz = torch.where(torch.isfinite(gz), gz, zero)
        all_zero = (gx == 0.0) & (gy == 0.0) & (gz == 0.0)
        one = torch.ones_like(gx)
        gx = torch.where(all_zero, one, gx)
        gy = torch.where(all_zero, one, gy)
        gz = torch.where(all_zero, one, gz)
        gz = torch.abs(gz) + 0.001
        norm = torch.sqrt(gx * gx + gy * gy + gz * gz) + _EPS
        gx, gy, gz = gx / norm, gy / norm, gz / norm
        Yx[:, b] = ax + L * gx
        Yy[:, b] = ay + L * gy
        Yz[:, b] = az + L * gz
        gxs.append(gx)
        gys.append(gy)
        gzs.append(gz)

    return (
        lines,
        rootsx[:, :, None],
        rootsy[:, :, None],
        rootsz[:, :, None],
        torch.stack(gxs, dim=2),  # (B, T, 49)
        torch.stack(gys, dim=2),
        torch.stack(gzs, dim=2),
        Yx.transpose(1, 2),
        Yy.transpose(1, 2),
        Yz.transpose(1, 2),
    )
