"""The plain reference's robust loss against the closed form it reduces to
at the trainer's latents: alpha = 2 and scale 0.5 make rho = 2 x^2, and the
spline's log Z(2) is log sqrt(2 pi) to its stated accuracy."""

from __future__ import annotations

import math

import torch

from portbench.reference import robust


def test_latents_and_loss_at_alpha_two():
    alpha, scale = robust.latents(torch.float64, "cpu")
    assert abs(float(alpha) - 2.0) < 1e-12 and abs(float(scale) - 0.5) < 1e-12
    x = torch.linspace(-3, 3, 61, dtype=torch.float64).reshape(1, -1)
    want = torch.mean(2.0 * x ** 2) + math.log(0.5) + 0.5 * math.log(2 * math.pi)
    assert abs(float(robust.robust_loss(x)) - float(want)) < 1e-5
