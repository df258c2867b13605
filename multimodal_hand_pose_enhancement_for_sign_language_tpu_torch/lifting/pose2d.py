"""2D pose preprocessing: normalization, pruning, interpolation.

PyTorch counterpart of the JAX package's ``lifting/pose2d.py`` (itself the
reference's 3DposeEstimator/pose2D.py:8-90).  Every function takes
(..., T, n) planes with any leading batch dims and an optional (..., T)
frame ``mask``, so padded (bucketed) clips compute statistics over their
real frames only.

NB the reference's ``normalization`` assigns its sigma clamp to a typo'd
name (pose2D.py:22-24), so sigma is used unclamped; reproduced.
"""

from __future__ import annotations

import torch


def normalization(Xx, Xy, mask=None):
    """Joint zero-mean / shared-sigma normalization over each clip.

    Returns (Xx_n, Xy_n, mux, muy, sigma); the statistics have the leading
    batch shape with two trailing singleton dims.
    """
    T, n = Xx.shape[-2:]
    if mask is None:
        mask = torch.ones(Xx.shape[:-1], dtype=Xx.dtype, device=Xx.device)
    m = mask[..., None]

    def total(a):
        return a.sum(dim=(-2, -1), keepdim=True)

    sum0 = mask.sum(dim=-1)[..., None, None] * n
    sum1Xx = total(Xx * m)
    sum2Xx = total(Xx * Xx * m)
    sum1Xy = total(Xy * m)
    sum2Xy = total(Xy * Xy * m)
    mux = sum1Xx / sum0
    muy = sum1Xy / sum0
    sum0 = 2 * sum0
    sum1 = sum1Xx + sum1Xy
    sum2 = sum2Xx + sum2Xy
    mu = sum1 / sum0
    sigma2 = (sum2 / sum0) - mu * mu
    sigma = torch.sqrt(sigma2)  # unclamped, as the reference
    return (Xx - mux) / sigma, (Xy - muy) / sigma, mux, muy, sigma


def prune(Xx, Xy, Xw, watch_this, threshold):
    """Zero out frames whose mean confidence over the ``watch_this`` joints
    is below ``threshold`` (pose2D.py:29-46)."""
    watch = torch.as_tensor(list(watch_this), device=Xw.device)
    Ew = Xw.index_select(-1, watch).mean(dim=-1)
    keep = (Ew >= threshold)[..., None].to(Xx.dtype)
    return Xx * keep, Xy * keep, Xw * keep


def interpolation(Xx, Xy, Xw, threshold, mask=None):
    """Confidence-weighted temporal interpolation with an expanding window
    (pose2D.py:49-90): for each (t, joint) the window [t-d, t+d] grows
    until its summed confidence reaches ``threshold`` or the clip ends.
    The sums accumulate side by side, radius by radius, like the JAX scan.
    """
    T = Xw.shape[-2]
    if mask is not None:
        Xw = Xw * mask[..., None]
    wx = Xw * Xx
    wy = Xw * Xy
    t_idx = torch.arange(T, device=Xw.device)
    done = Xw >= threshold
    sw, swx, swy = Xw, wx, wy
    for d in range(1, T):
        up = torch.clamp(t_idx + d, 0, T - 1)
        dn = torch.clamp(t_idx - d, 0, T - 1)
        up_ok = ((t_idx + d) < T)[:, None].to(Xw.dtype)
        dn_ok = ((t_idx - d) >= 0)[:, None].to(Xw.dtype)
        add_w = Xw[..., up, :] * up_ok + Xw[..., dn, :] * dn_ok
        add_x = wx[..., up, :] * up_ok + wx[..., dn, :] * dn_ok
        add_y = wy[..., up, :] * up_ok + wy[..., dn, :] * dn_ok
        grow = (~done).to(Xw.dtype)
        sw = sw + add_w * grow
        swx = swx + add_x * grow
        swy = swy + add_y * grow
        done = done | (sw >= threshold)
    sw = torch.where(sw <= 0.0, torch.full_like(sw, 1e-10), sw)
    return swx / sw, swy / sw, Xw
