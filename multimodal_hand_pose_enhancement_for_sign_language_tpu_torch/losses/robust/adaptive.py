"""The adaptive robust loss: per-dimension latent alpha and scale.

PyTorch counterpart of the JAX package's ``losses/robust/adaptive.py``
(reference utils/robust_loss/adaptive.py:51-198).  The latents are
``nn.Parameter``s of shape (1, num_dims), constrained by affine-sigmoid
(alpha in (alpha_lo, alpha_hi), init alpha_init) and affine-softplus
(scale in (scale_lo, inf), init scale_init).

Reference behavioral quirk, reproduced by the trainer: train_gan.py:69
passes only generator.parameters() to Adam, so these latents are created
but never optimized -- the effective loss is the fixed alpha=2, c=0.5 NLL.
The latents are still real parameters here; whether they are trained is
the optimizer's decision, exactly as in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.losses.robust import (
    distribution as _distribution,
    util,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops.robust_loss import (
    robust_lossfun,
)


class AdaptiveLossFunction(nn.Module):
    def __init__(self, num_dims: int, alpha_lo: float = 1.0, alpha_hi: float = 4.0,
                 alpha_init: Optional[float] = 2.0, scale_lo: float = 1e-5,
                 scale_init: float = 0.5):
        super().__init__()
        if not alpha_lo >= 0:
            raise ValueError(f"`alpha_lo` must be >= 0, but is {alpha_lo}")
        if not alpha_hi >= alpha_lo:
            raise ValueError(
                f"`alpha_hi` = {alpha_hi} must be >= `alpha_lo` = {alpha_lo}"
            )
        if (
            alpha_init is not None
            and alpha_lo != alpha_hi
            and not (alpha_lo < alpha_init < alpha_hi)
        ):
            raise ValueError(
                f"`alpha_init` = {alpha_init} must be in ({alpha_lo}, {alpha_hi})"
            )
        if not scale_lo > 0:
            raise ValueError(f"`scale_lo` must be > 0, but is {scale_lo}")
        if not scale_init >= scale_lo:
            raise ValueError(
                f"`scale_init` = {scale_init} must be >= `scale_lo` = {scale_lo}"
            )
        self.num_dims = num_dims
        self.alpha_lo, self.alpha_hi, self.alpha_init = alpha_lo, alpha_hi, alpha_init
        self.scale_lo, self.scale_init = scale_lo, scale_init
        self.distribution = _distribution.Distribution()
        if alpha_lo != alpha_hi:
            a_init = (alpha_lo + alpha_hi) / 2.0 if alpha_init is None else alpha_init
            latent = util.inv_affine_sigmoid(a_init, lo=alpha_lo, hi=alpha_hi)
            self.latent_alpha = nn.Parameter(
                torch.full((1, num_dims), float(latent), dtype=torch.float32))
        if scale_lo != scale_init:
            self.latent_scale = nn.Parameter(
                torch.zeros((1, num_dims), dtype=torch.float32))

    def _const(self, value):
        ref = self.distribution._values
        return torch.full((1, self.num_dims), value, dtype=torch.float32,
                          device=ref.device)

    def alpha(self):
        if self.alpha_lo == self.alpha_hi:
            return self._const(self.alpha_lo)
        return util.affine_sigmoid(self.latent_alpha, lo=self.alpha_lo, hi=self.alpha_hi)

    def scale(self):
        if self.scale_lo == self.scale_init:
            return self._const(self.scale_init)
        return util.affine_softplus(self.latent_scale, lo=self.scale_lo,
                                    ref=self.scale_init)

    def log_partition(self, alpha, scale):
        """log(c) + log Z(alpha): what the NLL adds to rho."""
        return torch.log(scale) + self.distribution.log_base_partition_function(alpha)

    def lossfun(self, x):
        """NLL per element of (batch, num_dims) residuals.  On a CUDA
        tensor rho comes from the hand-written kernel."""
        assert x.ndim == 2 and x.shape[1] == self.num_dims
        alpha, scale = self.alpha(), self.scale()
        return robust_lossfun(x, alpha, scale) + self.log_partition(alpha, scale)

    forward = lossfun
