"""Fit the log-partition spline for the robust-loss distribution.

The NLL of the Barron distribution needs log Z(alpha), where
Z(alpha) = integral exp(-rho(x, alpha, 1)) dx has no usable closed form.
The reference ships a precomputed spline resource; this generates one by
direct numerical quadrature (scipy), sampled on the compressed "partition
spline curve" x-axis so interpolation is well-conditioned around alpha=2.
The JAX package's offline tool, copied: numpy and scipy only.

Run:  python -m multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.\
losses.robust.fit_partition_spline

Writes this package's resources/partition_spline_generated.npz with
{x_scale, values, tangents}; log Z accuracy is ~1e-7 (checked against the
analytic Z(0) = pi*sqrt(2) and Z(2) = sqrt(2*pi)).
"""

from __future__ import annotations

import os

import numpy as np
from scipy import integrate

N_KNOTS = 1024
X_MAX = 12.0  # curved-space coverage: alpha from 0 to ~2e6


def curve_np(alpha):
    """partition_spline_curve in NumPy (distribution.py:87-111)."""
    alpha = np.asarray(alpha, dtype=np.float64)
    return np.where(
        alpha < 4,
        (2.25 * alpha - 4.5) / (np.abs(alpha - 2) + 0.25) + alpha + 2,
        5.0 / 18.0 * np.log(4 * alpha - 15) + 8,
    )


def inv_curve_np(x):
    x = np.asarray(x, dtype=np.float64)
    return np.where(
        x < 8,
        0.5 * x
        + np.where(
            x <= 4,
            1.25 - np.sqrt(np.maximum(1.5625 - x + 0.25 * x**2, 0.0)),
            -1.25 + np.sqrt(np.maximum(9.5625 - 3 * x + 0.25 * x**2, 0.0)),
        ),
        3.75 + 0.25 * np.exp(np.minimum(x * 3.6 - 28.8, 87.5)),
    )


def density_np(x, alpha):
    """exp(-rho(x, alpha, 1)) computed overflow-safely in log space."""
    xsq = x**2
    if alpha == 0:
        return 1.0 / (1.0 + 0.5 * xsq)
    if alpha == 2:
        return np.exp(-0.5 * xsq)
    beta = abs(alpha - 2.0)
    log_term = 0.5 * alpha * np.log1p(xsq / beta)
    rho = (beta / alpha) * np.expm1(min(log_term, 700.0))
    return np.exp(-min(rho, 745.0))


def partition_z(alpha: float) -> float:
    """Z(alpha) by adaptive quadrature (integrand is even)."""
    val, _ = integrate.quad(lambda x: density_np(x, alpha), 0, np.inf, limit=400, epsabs=1e-12, epsrel=1e-11)
    return 2.0 * val


def fit(n_knots: int = N_KNOTS, x_max: float = X_MAX):
    """{x_scale, values, tangents}: log Z at ``n_knots`` alphas evenly spaced
    on the curve's axis over [0, x_max]."""
    xs = np.linspace(0.0, x_max, n_knots)
    alphas = inv_curve_np(xs)
    alphas[0] = 0.0
    values = np.array([np.log(partition_z(float(a))) for a in alphas])
    # centered-difference tangents in knot-index space (spacing == 1 after
    # x_scale normalization)
    tangents = np.gradient(values)
    x_scale = (n_knots - 1) / x_max
    return dict(
        x_scale=np.float64(x_scale),
        values=values.astype(np.float64),
        tangents=tangents.astype(np.float64),
    )


def main():
    out_dir = os.path.join(os.path.dirname(__file__), "resources")
    os.makedirs(out_dir, exist_ok=True)
    # sanity: the quadrature must reproduce the analytic anchors
    err0 = abs(np.log(partition_z(0.0)) - np.log(np.pi * np.sqrt(2.0)))
    err2 = abs(np.log(partition_z(2.0)) - np.log(np.sqrt(2 * np.pi)))
    print(f"quadrature log Z(0) err={err0:.2e}, log Z(2) err={err2:.2e}")
    if not (err0 < 1e-9 and err2 < 1e-9):
        raise RuntimeError("the quadrature misses the analytic anchors")
    spline = fit()
    path = os.path.join(out_dir, "partition_spline_generated.npz")
    np.savez(path, **spline)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
