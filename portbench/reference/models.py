"""Plain reference of the two generators, the motion discriminator and their
seeded initialisation.

A frozen copy of the layer equations of the reference's modelZoo.py
(``regressor_fcn_bn_32``, ``regressor_fcn_bn_32_v2``,
``regressor_fcn_bn_discriminator``) in plain ``torch.nn``, independent of the
measured package: it imports nothing of it.  The modules register their
children in the reference's order, so ``init_default_`` draws the same
PyTorch-default weights from a seed as any implementation that draws them in
that order, and the state_dict keys are the reference's.  Any dtype works:
build in float32, then ``.to(torch.float64)``.

``Dropout`` draws its mask as ``torch.rand(shape, generator, dtype=float32) <
keep`` from a ``torch.Generator`` given to it, so a replay of the same
generator state draws the same masks.
"""

from __future__ import annotations

import math

import torch
from torch import nn

TEXT_EMBED_DIM = 512


class Dropout(nn.Dropout):
    generator = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        mask = torch.rand(x.shape, generator=self.generator, device=x.device,
                          dtype=torch.float32) < keep
        return x * mask.to(x.dtype) / keep


def set_dropout_generator(module, generator):
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator


class ConvBlock(nn.Sequential):
    def __init__(self, in_ch, out_ch, k=3, stride=1, pad=1, pool=False, dropout=0.5):
        layers = [Dropout(dropout), nn.Conv1d(in_ch, out_ch, k, stride, pad),
                  nn.LeakyReLU(0.2), nn.BatchNorm1d(out_ch, momentum=0.1, eps=1e-5)]
        if pool:
            layers.append(nn.MaxPool1d(2, 2))
        super().__init__(*layers)


class FeatEmbedBlock(nn.Sequential):
    def __init__(self, in_f, out_f, dropout=0.5):
        super().__init__(Dropout(dropout), nn.Linear(in_f, out_f), nn.LeakyReLU(0.2),
                         nn.BatchNorm1d(out_f, momentum=0.01, eps=1e-5))


class Decoder(nn.Sequential):
    def __init__(self, in_ch, out_dim, dropout=0.5):
        super().__init__(
            *ConvBlock(in_ch, in_ch, 3, 1, 1, dropout=dropout),
            Dropout(dropout),
            nn.ConvTranspose1d(in_ch, out_dim, 7, stride=2, padding=3, output_padding=1),
            nn.ReLU(),
            nn.BatchNorm1d(out_dim, momentum=0.1, eps=1e-5),
            Dropout(dropout),
            nn.Conv1d(out_dim, out_dim, 7, 1, 3),
        )


class _UNet32(nn.Module):
    def _add_trunk(self, in_ch, embed, bottleneck, out_dim, d):
        self.conv5 = ConvBlock(in_ch, embed, 3, 1, 1, dropout=d)
        self.conv6 = ConvBlock(embed, embed, 3, 1, 1, dropout=d)
        self.conv7 = ConvBlock(embed, bottleneck, 5, 2, 2, dropout=d)
        self.skip4 = ConvBlock(embed, embed, 3, 1, 1, dropout=d)
        self.skip5 = ConvBlock(embed, embed, 3, 1, 1, dropout=d)
        self.decoder = Decoder(embed, out_dim, dropout=d)

    def _trunk(self, fourth, at_bottleneck=None):
        fifth = self.conv5(fourth)
        sixth = self.conv6(fifth)
        seventh = self.conv7(sixth)
        if at_bottleneck is not None:
            seventh = at_bottleneck(seventh)
        up = torch.repeat_interleave(seventh, 2, dim=2)[:, :, :sixth.shape[2]]
        sixth = self.skip4(up + sixth)
        fifth = self.skip5(sixth + fifth)
        return self.decoder(fifth)


class regressor_fcn_bn_32(_UNet32):
    """v1 (modelZoo.py:29-118): text, when used, tiled per frame and
    concatenated on channels after the encoder."""

    def __init__(self, feature_in_dim, feature_out_dim, require_text=False,
                 default_size=256, dropout_rate=0.5):
        super().__init__()
        self.require_text = require_text
        embed = default_size * (2 if require_text else 1)
        d = dropout_rate
        self.encoder = ConvBlock(feature_in_dim, default_size, 3, 1, 1, pool=True, dropout=d)
        if require_text:
            self.text_embeds_postprocess = FeatEmbedBlock(TEXT_EMBED_DIM, default_size, dropout=d)
        self._add_trunk(embed, embed, embed, feature_out_dim, d)

    def forward(self, x, feats=None):
        B, _, T = x.shape
        fourth = self.encoder(x)
        if self.require_text:
            rows = feats[:, None, :].expand(B, T, feats.shape[1]).reshape(B * T, -1)
            feat = self.text_embeds_postprocess(rows).reshape(B, T, -1).transpose(1, 2)
            fourth = torch.cat([fourth, nn.functional.max_pool1d(feat, 2, 2)], dim=1)
        return self._trunk(fourth)


class regressor_fcn_bn_32_v2(_UNet32):
    """v2 (modelZoo.py:182-296): the text, projected to the full width, is one
    more time step of the bottleneck; the upsample keeps the first steps only,
    so the output does not depend on it (as in the reference)."""

    def __init__(self, feature_in_dim, feature_out_dim, require_text=False,
                 default_size=256, dropout_rate=0.5):
        super().__init__()
        self.require_text = require_text
        embed = default_size * (2 if require_text else 1)
        d = dropout_rate
        self.encoder = ConvBlock(feature_in_dim, embed, 3, 1, 1, pool=True, dropout=d)
        if require_text:
            self.text_embeds_postprocess = FeatEmbedBlock(TEXT_EMBED_DIM, embed, dropout=d)
        self._add_trunk(embed, embed, embed, feature_out_dim, d)

    def forward(self, x, feats=None):
        at_bottleneck = None
        if self.require_text:
            def at_bottleneck(seventh):
                feat = self.text_embeds_postprocess(feats)
                return torch.cat([seventh, feat[:, :, None]], dim=2)
        return self._trunk(self.encoder(x), at_bottleneck)


class regressor_fcn_bn_discriminator(nn.Module):
    """Motion discriminator (modelZoo.py:767-813): 7 stride-2 conv blocks,
    then Conv1d(8 -> 1, k3)."""

    def __init__(self, feature_in_dim, dropout_rate=0.5):
        super().__init__()
        layers, in_ch = [], feature_in_dim
        for ch in (64, 64, 32, 32, 16, 16, 8):
            layers += list(ConvBlock(in_ch, ch, 5, 2, 2, dropout=dropout_rate))
            in_ch = ch
        layers += [Dropout(dropout_rate), nn.Conv1d(in_ch, 1, 3, 1, 1)]
        self.convs = nn.Sequential(*layers)

    def forward(self, x):
        return self.convs(x)


GENERATORS = {
    "regressor_fcn_bn_32": regressor_fcn_bn_32,
    "regressor_fcn_bn_32_v2": regressor_fcn_bn_32_v2,
}


@torch.no_grad()
def init_default_(module, seed):
    """PyTorch's default initialisation drawn from ``torch.Generator()``
    seeded with ``seed``: every Conv1d, ConvTranspose1d and Linear weight, then
    its bias, U(-b, b), b = 1/sqrt(fan_in), fan_in = weight dim 1 times the
    kernel size; BatchNorm weight 1, bias 0, running mean 0, variance 1."""
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d, nn.Linear)):
            w = m.weight
            fan_in = w.shape[1] * (w[0][0].numel() if w.dim() > 2 else 1)
            bound = 1.0 / math.sqrt(fan_in)
            for p in (m.weight, m.bias):
                p.copy_(torch.rand(p.shape, generator=gen) * (2 * bound) - bound)
        elif isinstance(m, nn.BatchNorm1d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()


def build_generator(cfg, seed, dtype=torch.float64, device="cpu"):
    """The configuration's generator (``cfg['class']``), seeded, in eval mode."""
    net = GENERATORS[cfg["class"]](
        cfg["feature_in_dim"], cfg["feature_out_dim"], require_text=cfg["require_text"],
        default_size=cfg["default_size"], dropout_rate=cfg["dropout"])
    init_default_(net, seed)
    return net.to(device=device, dtype=dtype).eval()


def build_discriminator(cfg, seed, dtype=torch.float64, device="cpu"):
    net = regressor_fcn_bn_discriminator(cfg["feature_out_dim"], dropout_rate=cfg["dropout"])
    init_default_(net, seed)
    return net.to(device=device, dtype=dtype).eval()
