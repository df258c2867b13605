"""The probability distribution induced by the robust loss (PyTorch).

NLL and sampling for the Barron distribution (reference
utils/robust_loss/distribution.py:87-280); counterpart of the JAX
package's ``losses/robust/distribution.py``.  The log-partition function
is a cubic Hermite spline over a compressed alpha axis, read from this
package's own copy of ``resources/partition_spline_generated.npz``.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
from torch import nn

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.losses.robust import (
    cubic_spline,
    general,
    util,
)

_RESOURCE = os.path.join(
    os.path.dirname(__file__), "resources", "partition_spline_generated.npz"
)


def partition_spline_curve(alpha):
    """Compress alpha >= 0 for spline interpolation (distribution.py:87-111)."""
    alpha = util._f32(alpha)
    return torch.where(
        alpha < 4,
        (2.25 * alpha - 4.5) / (torch.abs(alpha - 2) + 0.25) + alpha + 2,
        5.0 / 18.0 * util.log_safe(4 * alpha - 15) + 8,
    )


def inv_partition_spline_curve(x):
    """Inverse of partition_spline_curve (distribution.py:114-123)."""
    x = util._f32(x)
    return torch.where(
        x < 8,
        0.5 * x
        + torch.where(
            x <= 4,
            1.25 - torch.sqrt(torch.clamp(1.5625 - x + 0.25 * x**2, min=0.0)),
            -1.25 + torch.sqrt(torch.clamp(9.5625 - 3 * x + 0.25 * x**2, min=0.0)),
        ),
        3.75 + 0.25 * util.exp_safe(x * 3.6 - 28.8),
    )


class Distribution(nn.Module):
    """Holds the log-partition spline (buffers that follow ``.to(device)``
    and stay out of the state_dict); stateless otherwise."""

    def __init__(self, resource: str = _RESOURCE):
        super().__init__()
        if not os.path.exists(resource):
            raise FileNotFoundError(f"partition spline resource missing: {resource}")
        with np.load(resource) as f:
            for name in ("x_scale", "values", "tangents"):
                self.register_buffer(
                    f"_{name}", torch.from_numpy(f[name].astype(np.float32)),
                    persistent=False)

    def log_base_partition_function(self, alpha):
        """log Z(alpha) for alpha >= 0, accurate to ~1e-5."""
        x = partition_spline_curve(alpha)
        return cubic_spline.interpolate1d(
            x * self._x_scale.to(x.dtype),
            self._values.to(x.dtype),
            self._tangents.to(x.dtype),
        )

    def nllfun(self, x, alpha, scale):
        """-log p(x | 0, alpha, scale) (Eq. 16)."""
        alpha = torch.as_tensor(alpha, dtype=x.dtype, device=x.device)
        scale = torch.as_tensor(scale, dtype=x.dtype, device=x.device)
        loss = general.lossfun(x, alpha, scale)
        log_partition = torch.log(scale) + self.log_base_partition_function(alpha)
        return loss + log_partition

    def draw_samples(self, generator: torch.Generator, alpha, scale,
                     max_rounds: int = 1000):
        """Rejection sampling (Algorithm 1 of the paper); Cauchy proposal.

        Vectorized over alpha/scale; loops until every slot accepts (the
        acceptance rate is ~0.3+, so a handful of rounds).  The random
        numbers come from ``generator``, on its device."""
        dev = generator.device
        alpha = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
        scale = torch.as_tensor(scale, dtype=torch.float32, device=dev)
        shape = alpha.shape
        samples = torch.zeros(shape, device=dev)
        accepted = torch.zeros(shape, dtype=torch.bool, device=dev)
        log_z = self.log_base_partition_function(alpha)
        one = torch.ones((), device=dev)
        zero = torch.zeros((), device=dev)
        for _ in range(max_rounds):
            u1 = torch.rand(shape, generator=generator, device=dev)
            cauchy = torch.tan(math.pi * (u1 - 0.5)) * math.sqrt(2.0)
            nll = self.nllfun(cauchy, alpha, one)
            nll_bound = general.lossfun(cauchy, zero, one) + log_z
            u = torch.rand(shape, generator=generator, device=dev)
            accept = u <= torch.exp(nll_bound - nll)
            samples = torch.where(accept & ~accepted, cauchy, samples)
            accepted = accepted | accept
            if bool(accepted.all()):
                break
        return samples * scale
