"""Plain reference of Barron's adaptive robust loss as the GAN trainer uses it.

The loss of a (B, T * D) residual is mean(rho(x, alpha, c) + log c +
log Z(alpha)) with per-column latents that no optimizer holds, so alpha and c
stay at their initial values: alpha = affine_sigmoid(logit((2 - 1) / 3)) on
(1, 4) and c = affine_softplus(0) with lo 1e-5 and ref 0.5 (the reference's
utils/robust_loss/adaptive.py and util.py).  rho is the general form with its
alpha = 0 and alpha = 2 closed forms (general.py); log Z is the cubic Hermite
spline of the reference's ``partition_spline_generated.npz``, copied here as
``partition_spline.npz``.  Plain torch, any dtype.
"""

from __future__ import annotations

import os

import numpy as np
import torch

_SPLINE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "partition_spline.npz")
ALPHA_LO, ALPHA_HI, ALPHA_INIT = 1.0, 4.0, 2.0
SCALE_LO, SCALE_INIT = 1e-5, 0.5


def latents(dtype, device):
    """(alpha, scale) as 0-d tensors: the latents' initial values mapped."""
    p = (ALPHA_INIT - ALPHA_LO) / (ALPHA_HI - ALPHA_LO)
    logit = -torch.log(torch.tensor(1.0 / p - 1.0, dtype=dtype, device=device))
    alpha = 1.0 / (1.0 + torch.exp(-logit)) * (ALPHA_HI - ALPHA_LO) + ALPHA_LO
    one = torch.tensor(1.0, dtype=dtype, device=device)
    shift = torch.log(torch.expm1(one))
    softplus = torch.logaddexp(shift, torch.zeros_like(shift))
    scale = (SCALE_INIT - SCALE_LO) * softplus + SCALE_LO
    return alpha, scale


def rho(x, alpha, scale):
    eps = float(np.finfo(np.float32).eps)
    sq = (x / scale) ** 2
    beta = torch.clamp(torch.abs(alpha - 2.0), min=eps)
    sign = torch.where(alpha >= 0, 1.0, -1.0).to(x.dtype)
    alpha_safe = sign * torch.clamp(torch.abs(alpha), min=eps)
    general = (beta / alpha_safe) * (torch.pow(sq / beta + 1.0, 0.5 * alpha) - 1.0)
    return torch.where(alpha == 0, torch.log1p(0.5 * sq),
                       torch.where(alpha == 2, 0.5 * sq, general))


def log_partition(alpha):
    """log Z(alpha) for 0 <= alpha < 4 from the spline."""
    with np.load(_SPLINE) as f:
        x_scale = float(f["x_scale"])
        values = torch.from_numpy(f["values"].astype(np.float64)).to(alpha)
        tangents = torch.from_numpy(f["tangents"].astype(np.float64)).to(alpha)
    x = ((2.25 * alpha - 4.5) / (torch.abs(alpha - 2) + 0.25) + alpha + 2) * x_scale
    lo = torch.floor(torch.clamp(x, 0.0, values.shape[0] - 2)).long()
    t = x - lo.to(x.dtype)
    h01 = -2.0 * t ** 3 + 3.0 * t ** 2
    h11 = t ** 3 - t ** 2
    h10 = h11 - t ** 2 + t
    return (values[lo] * (1.0 - h01) + values[lo + 1] * h01 + tangents[lo] * h10
            + tangents[lo + 1] * h11)


def robust_loss(resid):
    """The trainer's mean negative log-likelihood of a (B, N) residual."""
    alpha, scale = latents(resid.dtype, resid.device)
    return torch.mean(rho(resid, alpha, scale) + torch.log(scale) + log_partition(alpha))
