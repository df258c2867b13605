"""The yardstick's arithmetic: the chip's peaks, the operations of a model's
forward counted from its layer shapes, the GAN steps' operations, and the
operations and bytes the two hand-written kernels need.

Every count depends on the work, never on how the program does it:
a convolution or linear layer counts 2 x its multiply-adds, whatever
algorithm runs it; the lifting filter counts 16 flops per live joint-step
per cycle; the robust loss counts its bytes read and written once.
"""

from __future__ import annotations

import torch
from torch import nn

from portbench.reference import models

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_FP32_FLOPS = 67e12  # float32 on the CUDA cores (TF32 off)
PEAK_HBM_BYTES = 3.35e12

# the filter's update (the reference's pose3D.py:93-109), per joint-step and
# cycle: x and y (s - s1) * pm, a * s + b, - sd, + sd_prev: 6 flops each; z 4
FILTER_FLOPS_PER_ELEMENT_CYCLE = 16
FILTER_BYTES_PER_ELEMENT = 36  # six float32 planes read, three written
# Barron's loss: x read, the loss and d loss / dx written, float32; plus the
# alpha and scale rows
ROBUST_BYTES_PER_ELEMENT = 12
ROBUST_BYTES_PER_COLUMN = 8


def layer_flops(module, x, *rest):
    """2 x the multiply-adds of every Conv1d, ConvTranspose1d and Linear in
    one forward of ``module`` on inputs of the given shapes, read by hooks
    from each layer's input and output shapes.  Runs on the meta device, so
    it costs no memory and no time."""
    total = [0]

    def hook(m, inp, out):
        if isinstance(m, nn.Conv1d):
            total[0] += 2 * out.numel() * m.in_channels * m.kernel_size[0] // m.groups
        elif isinstance(m, nn.ConvTranspose1d):
            total[0] += 2 * inp[0].numel() * m.out_channels * m.kernel_size[0] // m.groups
        elif isinstance(m, nn.Linear):
            total[0] += 2 * out.numel() * m.in_features

    handles = [m.register_forward_hook(hook) for m in module.modules()
               if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d, nn.Linear))]
    try:
        with torch.no_grad():
            module(*(torch.empty(s, device="meta") if s is not None else None
                     for s in (x, *rest)))
    finally:
        for h in handles:
            h.remove()
    return total[0]


def _meta(make):
    with torch.device("meta"):
        return make().eval()


def generator_flops(cfg, B, T):
    """One generator forward on (B, Din, T) windows (and (B, 512) text)."""
    net = _meta(lambda: models.GENERATORS[cfg["class"]](
        cfg["feature_in_dim"], cfg["feature_out_dim"], require_text=cfg["require_text"],
        default_size=cfg["default_size"], dropout_rate=cfg["dropout"]))
    feats = (B, models.TEXT_EMBED_DIM) if cfg["require_text"] else None
    return layer_flops(net, (B, cfg["feature_in_dim"], T), feats)


def discriminator_flops(cfg, B, T):
    """One discriminator forward on the (B, Dout, T - 1) motion of T frames."""
    net = _meta(lambda: models.regressor_fcn_bn_discriminator(cfg["feature_out_dim"]))
    return layer_flops(net, (B, cfg["feature_out_dim"], T - 1))


def step_flops(cfg, kind, B, T):
    """The counting rule of a GAN step: a backward counts twice its forward.
    G: the G forward and backward, and D's no-grad forward of the fake motion.
    D: G's no-grad forward, and two D forwards with their backwards.
    val: G's forward."""
    g, d = generator_flops(cfg, B, T), discriminator_flops(cfg, B, T)
    if kind == "g":
        return 3 * g + d
    if kind == "d":
        return g + 2 * 3 * d
    if kind == "val":
        return g
    raise ValueError(f"unknown step kind {kind!r}")


def filter_flops(live_elements, n_cycles):
    """The lifting filter's operations over ``live_elements`` unmasked
    joint-steps (a clip's frames x 50 joints)."""
    return FILTER_FLOPS_PER_ELEMENT_CYCLE * live_elements * n_cycles


def filter_bound_s(live_elements, n_cycles):
    """The least time the chip could take: the larger of the operations at
    the FP32 peak and the live planes' bytes at the HBM peak."""
    return max(filter_flops(live_elements, n_cycles) / PEAK_FP32_FLOPS,
               FILTER_BYTES_PER_ELEMENT * live_elements / PEAK_HBM_BYTES)


def robust_bytes(N, D):
    return ROBUST_BYTES_PER_ELEMENT * N * D + ROBUST_BYTES_PER_COLUMN * D


def robust_bound_s(N, D):
    return robust_bytes(N, D) / PEAK_HBM_BYTES
