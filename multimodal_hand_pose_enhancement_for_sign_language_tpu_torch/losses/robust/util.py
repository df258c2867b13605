"""Numerically-safe helpers and latent-parameter bijectors (PyTorch).

Counterpart of the JAX package's ``losses/robust/util.py`` (the Barron
robust-loss helper math, reference utils/robust_loss/util.py:27-106):
clamped log/exp and the affine-sigmoid / affine-softplus bijectors that
constrain the adaptive loss's latent alpha and scale.  Python numbers are
taken as float32, as JAX takes them, so the default latents come out bit
for bit the same.
"""

from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    """A tensor as is; a Python or numpy number as a float32 tensor."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x, dtype=torch.float32)


def log_safe(x):
    return torch.log(torch.clamp(_f32(x), max=33e37))


def log1p_safe(x):
    return torch.log1p(torch.clamp(_f32(x), max=33e37))


def exp_safe(x):
    return torch.exp(torch.clamp(_f32(x), max=87.5))


def expm1_safe(x):
    return torch.expm1(torch.clamp(_f32(x), max=87.5))


def inv_softplus(y):
    y = _f32(y)
    return torch.where(y > 87.5, y, torch.log(torch.expm1(y)))


def logit(y):
    return -torch.log(1.0 / _f32(y) - 1.0)


def affine_sigmoid(logits, lo=0.0, hi=1.0):
    """Maps reals to (lo, hi); 0 maps to (lo+hi)/2.  Written out as
    1 / (1 + exp(-x)), not ``torch.sigmoid``: the default latent must map
    to alpha == 2 exactly, which this form does."""
    if not lo < hi:
        raise ValueError(f"`lo` ({lo}) must be < `hi` ({hi})")
    return 1.0 / (1.0 + torch.exp(-_f32(logits))) * (hi - lo) + lo


def inv_affine_sigmoid(probs, lo=0.0, hi=1.0):
    if not lo < hi:
        raise ValueError(f"`lo` ({lo}) must be < `hi` ({hi})")
    return logit((_f32(probs) - lo) / (hi - lo))


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def affine_softplus(x, lo=0.0, ref=1.0):
    """Maps reals to (lo, inf); 0 maps to ref."""
    if not lo < ref:
        raise ValueError(f"`lo` ({lo}) must be < `ref` ({ref})")
    x = _f32(x)
    shift = inv_softplus(torch.ones((), dtype=x.dtype, device=x.device))
    return (ref - lo) * _softplus(x + shift) + lo


def inv_affine_softplus(y, lo=0.0, ref=1.0):
    if not lo < ref:
        raise ValueError(f"`lo` ({lo}) must be < `ref` ({ref})")
    y = _f32(y)
    shift = inv_softplus(torch.ones((), dtype=y.dtype, device=y.device))
    return inv_softplus((y - lo) / (ref - lo)) - shift


def students_t_nll(x, df, scale):
    """NLL of a Generalized Student's T (reference util.py:109-118)."""
    x, df, scale = _f32(x), _f32(df), _f32(scale)
    log_partition = (
        torch.log(torch.abs(scale))
        + torch.lgamma(0.5 * df)
        - torch.lgamma(0.5 * df + 0.5)
        + 0.5 * math.log(math.pi)
    )
    return (
        0.5 * ((df + 1.0) * torch.log1p((x / scale) ** 2.0 / df) + torch.log(df))
        + log_partition
    )
