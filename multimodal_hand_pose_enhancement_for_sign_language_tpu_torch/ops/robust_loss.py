"""Barron's general robust loss: hand-written Hopper kernel + plain version.

Replaces the TPU kernel ``ops/pallas_kernels.py: lossfun_pallas`` of the
JAX package (``_robust_fwd_pallas`` -> ``pl.pallas_call`` of
``_robust_kernel``, with the custom VJP ``_lossfun_fwd`` / ``_lossfun_bwd``).
Contract as there: x is (N, D) float32, alpha and scale are (1, D) rows or
scalars; the result is the elementwise loss rho(x, alpha, scale), (N, D).

* ``robust_lossfun``: the wrapper, differentiable.  A CPU tensor runs
  ``robust_lossfun_plain`` under autograd; a CUDA tensor launches
  ``csrc/robust_loss.cu`` (built at first use by ``ops/build.py``), which
  writes the loss and d loss / dx in one pass, or raises.  Its backward
  multiplies the saved dx by the incoming gradient; like the TPU kernel's
  VJP it sends the gradients of alpha and scale through the plain version,
  and only when they are asked for.  ``robust_lossfun.launches`` counts
  launches.
* ``robust_lossfun_plain``: ``losses/robust/general.lossfun`` of the JAX
  package in PyTorch, with all five closed forms.  The kernel has the three
  the TPU kernel has (alpha == 0, alpha == 2, general), so on a CUDA tensor
  alpha must be finite.

What bounds the kernel on an H100 is bytes: 12 B per element (x read, loss
and dx written, ``BYTES_PER_ELEMENT``) plus the two D-float rows, against
one ``powf`` or ``log1pf`` and a few divisions per element
(``FLOPS_PER_ELEMENT`` is a generous count of them).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops import build

_MACHINE_EPS = float(np.finfo(np.float32).eps)
# x read once, loss and dx written once, float32
BYTES_PER_ELEMENT = 12
# general branch: two divisions for x/c and x/c^2, u, base, powf (counted as
# 40: a log2, a multiply and an exp2 in extended precision), the loss and dx
# tails; an upper count, used only to show the bound is the bytes
FLOPS_PER_ELEMENT = 64


def robust_lossfun_plain(x, alpha, scale, approximate: bool = False,
                         epsilon: float = 1e-6):
    """rho(x, alpha, scale); broadcasts alpha/scale against x.

    alpha=-inf: Welsch; -2: Geman-McClure; 0: Cauchy; 1: Charbonnier;
    2: L2.  ``approximate`` uses the faster appendix form (inaccurate near
    x = alpha = 0)."""
    alpha = torch.as_tensor(alpha, dtype=x.dtype, device=x.device)
    alpha = alpha.broadcast_to(x.shape)
    scale = torch.as_tensor(scale, dtype=x.dtype, device=x.device)

    if approximate:
        assert epsilon > _MACHINE_EPS
        b = torch.abs(alpha - 2) + epsilon
        d = torch.where(alpha >= 0, alpha + epsilon, alpha - epsilon)
        return (b / d) * (torch.pow((x / scale) ** 2 / b + 1.0, 0.5 * d) - 1.0)

    squared_scaled_x = (x / scale) ** 2

    loss_two = 0.5 * squared_scaled_x
    loss_zero = torch.log1p(torch.clamp(0.5 * squared_scaled_x, max=33e37))
    loss_neginf = -torch.expm1(-0.5 * squared_scaled_x)
    loss_posinf = torch.expm1(torch.clamp(0.5 * squared_scaled_x, max=87.5))

    beta_safe = torch.clamp(torch.abs(alpha - 2.0), min=_MACHINE_EPS)
    sign = torch.where(alpha >= 0, 1.0, -1.0).to(x.dtype)
    alpha_safe = sign * torch.clamp(torch.abs(alpha), min=_MACHINE_EPS)
    loss_otherwise = (beta_safe / alpha_safe) * (
        torch.pow(squared_scaled_x / beta_safe + 1.0, 0.5 * alpha) - 1.0
    )

    return torch.where(
        alpha == -torch.inf,
        loss_neginf,
        torch.where(
            alpha == 0,
            loss_zero,
            torch.where(
                alpha == 2,
                loss_two,
                torch.where(alpha == torch.inf, loss_posinf, loss_otherwise),
            ),
        ),
    )


def _row(t, name, x):
    """alpha or scale as a contiguous D-float row on x's device."""
    if t.device != x.device:
        raise ValueError(f"robust_lossfun: {name} is on {t.device}, x on {x.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"robust_lossfun: {name} must be float32, got {t.dtype}")
    D = x.shape[1]
    try:
        return t.detach().broadcast_to((1, D)).contiguous()
    except RuntimeError:
        raise ValueError(
            f"robust_lossfun: {name} has shape {tuple(t.shape)}, which does not "
            f"broadcast to one row of {D}") from None


def robust_loss_and_dx(x, alpha, scale):
    """(loss, d loss / dx), each (N, D), from one launch of the CUDA kernel.
    x must be a contiguous float32 (N, D) CUDA tensor."""
    if x.device.type != "cuda":
        raise ValueError(f"robust_loss_and_dx: x is on {x.device}, not a CUDA device")
    if x.dtype != torch.float32:
        raise ValueError(f"robust_lossfun: x must be float32, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"robust_lossfun: x has shape {tuple(x.shape)}, want (N, D)")
    a = _row(alpha, "alpha", x)
    c = _row(scale, "scale", x)
    x = x.detach().contiguous()
    loss = torch.empty_like(x)
    dx = torch.empty_like(x)
    N, D = x.shape
    if N == 0 or D == 0:
        return loss, dx
    lib = build.load("robust_loss")
    fn = lib.mhpe_robust_loss
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), a.data_ptr(), c.data_ptr(), loss.data_ptr(),
                dx.data_ptr(), N, D, stream)
    if rc != 0:
        raise RuntimeError(f"robust_loss kernel launch failed: cudaError {rc}")
    robust_lossfun.launches += 1
    return loss, dx


class _RobustLossCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha, scale):
        loss, dx = robust_loss_and_dx(x, alpha, scale)
        ctx.latent_grads = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        if ctx.latent_grads:
            ctx.save_for_backward(dx, x, alpha, scale)
        else:
            ctx.save_for_backward(dx)
        return loss

    @staticmethod
    def backward(ctx, g):
        dx = ctx.saved_tensors[0]
        gx = g * dx if ctx.needs_input_grad[0] else None
        ga = gc = None
        if ctx.latent_grads:
            # no kernel for these on the TPU either: the plain version's
            # autograd, with x held constant
            _, x, alpha, scale = ctx.saved_tensors
            with torch.enable_grad():
                a = alpha.detach().requires_grad_(ctx.needs_input_grad[1])
                c = scale.detach().requires_grad_(ctx.needs_input_grad[2])
                wanted = [t for t in (a, c) if t.requires_grad]
                grads = list(torch.autograd.grad(
                    robust_lossfun_plain(x.detach(), a, c), wanted, g))
            ga = grads.pop(0) if ctx.needs_input_grad[1] else None
            gc = grads.pop(0) if ctx.needs_input_grad[2] else None
        return gx, ga, gc


def robust_lossfun(x, alpha, scale):
    """Elementwise rho(x, alpha, scale), differentiable; the CUDA kernel on
    a CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return robust_lossfun_plain(x, alpha, scale)
    if x.device.type != "cuda":
        raise ValueError(f"robust_lossfun: unsupported device {x.device}")
    if not isinstance(alpha, torch.Tensor):
        alpha = torch.as_tensor(alpha, dtype=torch.float32, device=x.device)
    if not isinstance(scale, torch.Tensor):
        scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    return _RobustLossCuda.apply(x, alpha, scale)


robust_lossfun.launches = 0
