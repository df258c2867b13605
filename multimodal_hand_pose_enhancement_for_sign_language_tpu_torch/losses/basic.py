"""Mean-reduced elementary losses with PyTorch-default semantics."""

from __future__ import annotations

import torch


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred - target))


def l2_loss(pred, target):
    return torch.mean(torch.square(pred - target))


mse_loss = l2_loss


def huber_loss(pred, target, delta: float = 1.0):
    """nn.HuberLoss(delta): quadratic within delta, linear outside."""
    err = torch.abs(pred - target)
    quad = 0.5 * torch.square(err)
    lin = delta * (err - 0.5 * delta)
    return torch.mean(torch.where(err <= delta, quad, lin))
