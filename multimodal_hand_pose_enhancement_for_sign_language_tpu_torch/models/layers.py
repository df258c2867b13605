"""Building blocks of the reference generators, in PyTorch's (B, C, T) layout.

The reference models are stacks of
``Dropout(0.5) -> Conv1d -> LeakyReLU(0.2) -> BatchNorm1d [-> MaxPool1d]``
(modelZoo.py:29-118).  The blocks here are ``nn.Sequential`` subclasses
with exactly the reference's child indices, so a reference state_dict
(``encoder.1.weight``, ``decoder.5.weight``, ...) loads with
``strict=True``.  BatchNorm is torch's own: eval uses the running
statistics; momentum 0.1 (0.01 in the feature branches); eps 1e-5.

Dropout is ``Dropout`` below, ``nn.Dropout`` at the same indices whose
mask comes from a ``torch.Generator`` that the trainer owns, so a training
run is a function of its seed and never touches the global generator.
"""

from __future__ import annotations

import math

import torch
from torch import nn


class Dropout(nn.Dropout):
    """``nn.Dropout`` whose mask is drawn from ``self.generator`` (set with
    ``set_dropout_generator``; None means the global generator).  The
    generator must live on the device of the input.  Eval mode and p = 0
    pass the input through."""

    generator = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        mask = torch.rand(x.shape, generator=self.generator, device=x.device,
                          dtype=x.dtype) < keep
        return x * mask / keep if keep > 0 else torch.zeros_like(x)


def set_dropout_generator(module: nn.Module, generator) -> None:
    """Make every ``Dropout`` under ``module`` draw from ``generator``."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator


class ConvBlock(nn.Sequential):
    """Dropout -> Conv1d -> LeakyReLU(0.2) -> BatchNorm1d [-> MaxPool1d(2)]
    (indices 0..3[, 4])."""

    def __init__(self, in_ch, out_ch, kernel_size=3, stride=1, padding=1,
                 pool=False, dropout=0.5):
        layers = [
            Dropout(dropout),
            nn.Conv1d(in_ch, out_ch, kernel_size, stride, padding),
            nn.LeakyReLU(0.2),
            nn.BatchNorm1d(out_ch, momentum=0.1, eps=1e-5),
        ]
        if pool:
            layers.append(nn.MaxPool1d(2, 2))
        super().__init__(*layers)


class FeatEmbedBlock(nn.Sequential):
    """Dropout -> Linear -> LeakyReLU(0.2) -> BatchNorm1d(momentum 0.01) on
    flattened (B*T, E) features: the text/image branch (modelZoo.py:19-24,
    182-187)."""

    def __init__(self, in_f, out_f, dropout=0.5):
        super().__init__(
            Dropout(dropout),
            nn.Linear(in_f, out_f),
            nn.LeakyReLU(0.2),
            nn.BatchNorm1d(out_f, momentum=0.01, eps=1e-5),
        )


def max_pool_time(x):
    """MaxPool1d(2, 2) over the time axis of (B, C, T)."""
    return nn.functional.max_pool1d(x, 2, 2)


def upsample_repeat(x, target_len):
    """repeat_interleave(2) along time, truncated to ``target_len``
    (modelZoo.py:294-296)."""
    return torch.repeat_interleave(x, 2, dim=2)[:, :, :target_len]


@torch.no_grad()
def init_torch_default_(module: nn.Module, generator: torch.Generator) -> None:
    """PyTorch's default initialisation, drawn from ``generator``.

    Conv, ConvTranspose and Linear weights and biases are U(-b, b) with
    b = 1/sqrt(fan_in) (kaiming_uniform with a=sqrt(5)); fan_in is taken
    from weight dim 1 times the kernel size, as torch does (for a
    transposed conv that is out_ch * k).  BatchNorm gets weight 1, bias 0,
    running mean 0, running var 1.  Values are drawn on the CPU, so a seed
    gives the same weights on every device.
    """
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d, nn.Linear)):
            w = m.weight
            fan_in = w.shape[1] * (w[0][0].numel() if w.dim() > 2 else 1)
            bound = 1.0 / math.sqrt(fan_in)
            for p in (m.weight, m.bias):
                vals = torch.rand(p.shape, generator=generator) * (2 * bound) - bound
                p.copy_(vals)
        elif isinstance(m, nn.BatchNorm1d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()
