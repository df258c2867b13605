"""1D cubic Hermite spline interpolation (PyTorch).

Knots sit at integer x = 0..len(values)-1; queries outside the span are
linearly extrapolated.  Counterpart of the JAX package's
``losses/robust/cubic_spline.py`` (reference
utils/robust_loss/cubic_spline.py:21-94).
"""

from __future__ import annotations

import torch


def interpolate1d(x, values, tangents):
    assert values.ndim == 1 and tangents.ndim == 1
    assert values.shape[0] == tangents.shape[0]

    x_lo = torch.floor(torch.clamp(x, 0.0, values.shape[0] - 2)).to(torch.int64)
    x_hi = x_lo + 1

    t = x - x_lo.to(x.dtype)
    t_sq = t**2
    t_cu = t * t_sq
    h01 = -2.0 * t_cu + 3.0 * t_sq
    h00 = 1.0 - h01
    h11 = t_cu - t_sq
    h10 = h11 - t_sq + t

    value_before = tangents[0] * t + values[0]
    value_after = tangents[-1] * (t - 1.0) + values[-1]

    value_mid = (
        values[x_lo] * h00
        + values[x_hi] * h01
        + tangents[x_lo] * h10
        + tangents[x_hi] * h11
    )
    return torch.where(t < 0.0, value_before,
                       torch.where(t > 1.0, value_after, value_mid))
