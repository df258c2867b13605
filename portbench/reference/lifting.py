"""Plain reference of the 2D -> 3D lifting (the reference's
3DposeEstimator: pose2D.py normalization and prune, pose2Dto3D.py
initialization, pose3D.py forward kinematics and the 900-step SGD filter,
driven per clip as utils/utils.py:44-92 drives them).

A frozen copy of the plain masked formulation, in plain torch and any dtype:
clips are padded into one (B, T) batch with a frame mask, so statistics,
medians and the filter's sums run over each clip's real frames only, and a
padded step never reaches a real one.  Each clip's root noise is the
reference's RandomState(1234): T uniforms in [-0.001, 0.001) for x, then y,
then z, drawn in float64 and cast to float32.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import skeleton

PRUNE_WATCH = (0, 1, 2, 3, 4, 5, 6, 7)
PRUNE_THRESHOLD = 0.3
NOISE_SIGMA = 0.001
LR = 20.0
EPS = 1e-10


def clip_noise(T):
    rng = np.random.RandomState(1234)
    return np.stack([rng.uniform(-NOISE_SIGMA, NOISE_SIGMA, size=T).astype(np.float32)
                     for _ in range(3)])


def normalization(Xx, Xy, mask):
    n = Xx.shape[-1]
    m = mask[..., None]

    def total(a):
        return a.sum(dim=(-2, -1), keepdim=True)

    count = mask.sum(dim=-1)[..., None, None] * n
    s1x, s2x = total(Xx * m), total(Xx * Xx * m)
    s1y, s2y = total(Xy * m), total(Xy * Xy * m)
    mux, muy = s1x / count, s1y / count
    mu = (s1x + s1y) / (2 * count)
    sigma = torch.sqrt((s2x + s2y) / (2 * count) - mu * mu)  # unclamped, as pose2D.py
    return (Xx - mux) / sigma, (Xy - muy) / sigma


def prune(Xx, Xy, Xw):
    watch = torch.as_tensor(PRUNE_WATCH, device=Xw.device)
    keep = (Xw.index_select(-1, watch).mean(dim=-1) >= PRUNE_THRESHOLD)[..., None]
    keep = keep.to(Xx.dtype)
    return Xx * keep, Xy * keep, Xw * keep


def bone_length_classes(Xx, Xy, mask):
    """Log median 2D length per bone-length class (pose2Dto3D.py:100-116):
    the median is sorted[int(0.5 * (n - 1))] over each clip's real frames."""
    B = Xx.shape[0]
    J, E = skeleton.BONE_START, skeleton.BONE_END
    dx = Xx[:, :, J] - Xx[:, :, E]
    dy = Xy[:, :, J] - Xy[:, :, E]
    L = torch.sqrt(dx * dx + dy * dy)
    t_real = mask.sum(dim=1).to(torch.int64)
    L = torch.where(mask[:, :, None] > 0, L, torch.full_like(L, torch.inf))
    lines = []
    for c in range(skeleton.N_LENGTH_CLASSES):
        members = np.nonzero(skeleton.BONE_LENGTH_CLASS == c)[0]
        pool = torch.sort(L[:, :, members].reshape(B, -1), dim=1).values
        idx = ((t_real * len(members) - 1) // 2).clamp(min=0)
        lines.append(torch.log(pool.gather(1, idx[:, None])[:, 0] + 1e-9))
    return torch.stack(lines, dim=1)


def compute_b(ax, ay, az, tx, ty, L):
    """pose2Dto3D.py:33-65: up to five angle hypotheses a frame; the first
    minimum of the 2D reprojection error wins."""
    dx, dy = tx - ax, ty - ay
    foo = L ** 2 - dx ** 2 - dy ** 2
    sq = torch.sqrt(torch.clamp(foo, min=0.0))
    foo1 = ax ** 2 - 2 * ax * tx + ay ** 2 - 2 * ay * ty + tx ** 2 + ty ** 2
    foo2 = (1.0 / foo1) ** 0.5
    common = (ay ** 3 / foo1 + (ax ** 2 * ay) / foo1 + (ay * tx ** 2) / foo1
              + (ay * ty ** 2) / foo1 - (2 * ay ** 2 * ty) / foo1
              - (2 * ax * ay * tx) / foo1)
    foo3 = common + L * ay * foo2 - L * ty * foo2
    foo4 = common - L * ay * foo2 + L * ty * foo2
    xx1 = -(ax * ty - ay * tx - ax * foo3 + tx * foo3) / (ay - ty)
    xx2 = -(ax * ty - ay * tx - ax * foo4 + tx * foo4) / (ay - ty)
    zeros = torch.zeros_like(dx)
    finite34 = torch.isfinite(0.0 * xx1 * xx2 * foo3 * foo4)
    cands = [(dx, dy, -sq, foo >= 0), (dx, dy, sq, foo >= 0),
             (xx1 - ax, foo3 - ay, zeros, finite34), (xx2 - ax, foo4 - ay, zeros, finite34)]

    def err(hx, hy, hz):
        nh = torch.sqrt(hx * hx + hy * hy + hz * hz) + EPS
        return (ax + L * hx / nh - tx) ** 2 + (ay + L * hy / nh - ty) ** 2

    inf = torch.full_like(dx, torch.inf)
    e0 = err(dx, dy, zeros)
    best = torch.where(torch.isfinite(e0), e0, inf)
    bx, by, bz = dx, dy, zeros
    for hx, hy, hz, valid in cands:
        e = err(hx, hy, hz)
        e = torch.where(valid & torch.isfinite(e), e, inf)
        better = e < best
        best = torch.where(better, e, best)
        bx, by, bz = (torch.where(better, h, b) for h, b in ((hx, bx), (hy, by), (hz, bz)))
    keep0 = ~torch.isfinite(e0)
    return (torch.where(keep0, dx, bx), torch.where(keep0, dy, by),
            torch.where(keep0, zeros, bz))


def initialization(Xx, Xy, mask, noise):
    """pose2Dto3D.py:73-159: bone lengths, then each bone's angle from its
    parent joint, with the reference's nan/inf guards; returns the log
    lengths, the roots and the unit angle vectors."""
    B, T, n = Xx.shape
    lines = bone_length_classes(Xx, Xy, mask)
    cls = torch.as_tensor(skeleton.BONE_LENGTH_CLASS, dtype=torch.int64, device=Xx.device)
    Lb = torch.exp(lines[:, cls])
    rx, ry = Xx[:, :, 0] + noise[:, 0], Xy[:, :, 0] + noise[:, 1]
    rz = torch.zeros_like(rx) + noise[:, 2]
    Yx = torch.zeros((B, n, T), dtype=Xx.dtype, device=Xx.device)
    Yy, Yz = torch.zeros_like(Yx), torch.zeros_like(Yx)
    Yx[:, 0], Yy[:, 0], Yz[:, 0] = rx, ry, rz
    XxT, XyT = Xx.transpose(1, 2), Xy.transpose(1, 2)
    gs = []
    for i in range(skeleton.N_BONES):
        a, b = int(skeleton.BONE_START[i]), int(skeleton.BONE_END[i])
        L = Lb[:, i:i + 1]
        gx, gy, gz = compute_b(Yx[:, a], Yy[:, a], Yz[:, a], XxT[:, b], XyT[:, b], L)
        gx, gy, gz = (torch.where(torch.isfinite(g), g, torch.zeros_like(g))
                      for g in (gx, gy, gz))
        zero = (gx == 0.0) & (gy == 0.0) & (gz == 0.0)
        gx, gy, gz = (torch.where(zero, torch.ones_like(g), g) for g in (gx, gy, gz))
        gz = torch.abs(gz) + 0.001
        nrm = torch.sqrt(gx * gx + gy * gy + gz * gz) + EPS
        gx, gy, gz = gx / nrm, gy / nrm, gz / nrm
        Yx[:, b] = Yx[:, a] + L * gx
        Yy[:, b] = Yy[:, a] + L * gy
        Yz[:, b] = Yz[:, a] + L * gz
        gs.append((gx, gy, gz))
    angles = [torch.stack([g[k] for g in gs], dim=2) for k in range(3)]
    return lines, (rx, ry, rz), angles


def forward_kinematics(lines, roots, angles):
    """pose3D.py:60-91: x[b] = x[a] + L * A / ||A|| over the tree."""
    ax, ay, az = angles
    B, T, _ = ax.shape
    cls = torch.as_tensor(skeleton.BONE_LENGTH_CLASS, dtype=torch.int64, device=ax.device)
    Lb = torch.exp(lines[:, cls])
    nA = torch.sqrt(ax * ax + ay * ay + az * az) + EPS
    U = [(a / nA).transpose(1, 2) for a in (ax, ay, az)]
    P = [torch.zeros((B, skeleton.N_JOINTS, T), dtype=ax.dtype, device=ax.device)
         for _ in range(3)]
    for k in range(3):
        P[k][:, 0] = roots[k]
    for i in range(skeleton.N_BONES):
        a, b = int(skeleton.BONE_START[i]), int(skeleton.BONE_END[i])
        for k in range(3):
            P[k][:, b] = P[k][:, a] + Lb[:, i:i + 1] * U[k][:, i]
    return [p.transpose(1, 2) for p in P]


def sgd_filter(x, y, z, tarx, tary, w, mask, n_cycles):
    """pose3D.py:93-109: n_cycles gradient steps (lr 20) of the mean
    weighted squared 2D error plus the mean squared step-to-step motion."""
    n = x.shape[2]
    t_real = mask.sum(dim=1)[:, None, None]
    denom_data, denom_smooth = t_real * n, (t_real - 1.0) * n
    wm = w * mask[:, :, None]
    pair = (mask[:, :-1] * mask[:, 1:])[:, :, None]

    def smooth_grad(s):
        d2 = 2.0 * ((s[:, :-1] - s[:, 1:]) * pair)
        return torch.nn.functional.pad(d2, (0, 0, 0, 1)) - torch.nn.functional.pad(d2, (0, 0, 1, 0))

    for _ in range(n_cycles):
        gx = 2.0 * wm * (x - tarx) / denom_data + smooth_grad(x) / denom_smooth
        gy = 2.0 * wm * (y - tary) / denom_data + smooth_grad(y) / denom_smooth
        gz = smooth_grad(z) / denom_smooth
        x, y, z = x - LR * gx, y - LR * gy, z - LR * gz
    return x, y, z


def lift(clips, n_cycles, device, dtype=torch.float64):
    """(T_i, 150) OpenPose clips (x, y, confidence per joint) -> list of
    (T_i, 150) xyz clips (joint j at columns 3j..3j+2), as numpy."""
    B, T = len(clips), max(c.shape[0] for c in clips)
    kps = np.zeros((B, T, 150), np.float32)
    mask = np.zeros((B, T), np.float32)
    noise = np.zeros((B, 3, T), np.float32)
    for i, c in enumerate(clips):
        kps[i, :len(c)] = c
        mask[i, :len(c)] = 1.0
        noise[i, :, :len(c)] = clip_noise(len(c))
    kps, mask, noise = (torch.from_numpy(a).to(device, dtype) for a in (kps, mask, noise))
    Xx, Xy = normalization(kps[:, :, 0::3], kps[:, :, 1::3], mask)
    Xx, Xy, Xw = prune(Xx, Xy, kps[:, :, 2::3])
    m = mask[:, :, None]
    Xx, Xy, Xw = Xx * m, Xy * m, Xw * m
    lines, roots, angles = initialization(Xx, Xy, mask, noise)
    x0, y0, z0 = forward_kinematics(lines, roots, angles)
    x, y, z = sgd_filter(x0, y0, z0, Xx, Xy, Xw, mask, n_cycles)
    xyz = torch.stack((x, y, z), dim=-1).reshape(B, T, 150).cpu()
    xyz = (xyz.float() if xyz.dtype == torch.bfloat16 else xyz).numpy()
    return [xyz[i, :len(c)] for i, c in enumerate(clips)]
