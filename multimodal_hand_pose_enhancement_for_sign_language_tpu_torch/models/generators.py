"""The five generators, their decoder, and the motion discriminator.

PyTorch counterpart of the JAX package's ``models/generators.py``, which
re-implements the reference modelZoo.py:

  * ``regressor_fcn_bn_32`` "v1" -- text tiled per frame, channel-concat
    after the encoder,
  * ``regressor_fcn_bn_32_b2h`` "b2h" -- ResNet hand-crop features per
    frame, channel-concat after the encoder,
  * ``regressor_fcn_bn_32_v2`` "v2" -- text projected to the full width and
    concatenated along *time* at the bottleneck,
  * ``regressor_fcn_bn_32_v4`` "v4" -- conv7 halves the channels when text
    is used; the text fills the other half at the bottleneck,
  * ``regressor_fcn_bn_32_v4_deeper`` -- conv8-10 and skip1-4, with the
    reference's dead branch,
  * ``regressor_fcn_bn_discriminator`` -- 7 stride-2 conv blocks over
    motion deltas.

Child names and ``nn.Sequential`` indices are the reference's, so
reference ``.pth`` checkpoints and the JAX package's converted weights load
with ``strict=True``.  Input and output are (B, D, T); text features are
(B, 512) per clip, image features (B, T, 2000) per frame.
"""

from __future__ import annotations

import torch
from torch import nn

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models.layers import (
    ConvBlock,
    Dropout,
    FeatEmbedBlock,
    max_pool_time,
    upsample_repeat,
)

TEXT_EMBED_DIM = 512  # CLIP text embedding size (modelZoo.py:184)
IMAGE_FEAT_DIM = 2000  # ResNet-50 features, 1000 per hand (modelZoo.py:21)


class Decoder(nn.Sequential):
    """Shared decoder tail (modelZoo.py:105-118 / 268-281): indices
    0 Dropout, 1 Conv1d(k3), 2 LeakyReLU, 3 BN, 4 Dropout,
    5 ConvTranspose1d(k7, s2, p3, output_padding=1) (doubles T), 6 ReLU,
    7 BN, 8 Dropout, 9 Conv1d(k7)."""

    def __init__(self, in_ch, out_dim, dropout=0.5):
        super().__init__(
            *ConvBlock(in_ch, in_ch, 3, 1, 1, dropout=dropout),
            Dropout(dropout),
            nn.ConvTranspose1d(in_ch, out_dim, 7, stride=2, padding=3,
                               output_padding=1),
            nn.ReLU(),
            nn.BatchNorm1d(out_dim, momentum=0.1, eps=1e-5),
            Dropout(dropout),
            nn.Conv1d(out_dim, out_dim, 7, 1, 3),
        )


def _per_step(branch, rows, B, T):
    """A feature branch applied to (B*T, E) rows -> (B, C, T)."""
    return branch(rows).reshape(B, T, -1).transpose(1, 2)


def _tiled(feats, T):
    """(B, E) per-clip vectors -> (B*T, E), each repeated at every step, as
    the reference tiles them before its Linear and BatchNorm (whose
    statistics then count B*T rows)."""
    B, E = feats.shape
    return feats[:, None, :].expand(B, T, E).reshape(B * T, E)


class _UNet32(nn.Module):
    """The trunk that v1, b2h, v2 and v4 share: conv5 -> conv6 -> conv7
    (stride 2) -> [the bottleneck] -> skip4 -> skip5 -> decoder."""

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

        sixth = upsample_repeat(seventh, sixth.shape[2]) + sixth
        sixth = self.skip4(sixth)
        fifth = sixth + fifth
        fifth = self.skip5(fifth)
        return self.decoder(fifth)


class regressor_fcn_bn_32(_UNet32):
    """"v1": U-skip 1D conv FCN, optional per-frame text conditioning."""

    def __init__(self, feature_in_dim, feature_out_dim, require_text=False,
                 default_size=256, dropout_rate=0.5):
        super().__init__()
        self.feature_in_dim = feature_in_dim
        self.feature_out_dim = feature_out_dim
        self.require_text = require_text
        embed = default_size * (2 if require_text else 1)
        d = dropout_rate
        self.encoder = ConvBlock(feature_in_dim, default_size, 3, 1, 1,
                                 pool=True, dropout=d)
        if require_text:
            self.text_embeds_postprocess = FeatEmbedBlock(
                TEXT_EMBED_DIM, default_size, dropout=d
            )
        self._add_trunk(embed, embed, embed, feature_out_dim, d)

    def forward(self, x, feats=None):
        B, _, T = x.shape
        fourth = self.encoder(x)
        if self.require_text:
            # (B, E) -> tile over T -> Linear/BN on (B*T, E) -> maxpool/2
            feat = _per_step(self.text_embeds_postprocess, _tiled(feats, T), B, T)
            fourth = torch.cat([fourth, max_pool_time(feat)], dim=1)
        return self._trunk(fourth)


class regressor_fcn_bn_32_b2h(_UNet32):
    """"b2h": the v1 trunk, per-frame ResNet image-feature conditioning."""

    def __init__(self, feature_in_dim, feature_out_dim, require_image=False,
                 default_size=256, dropout_rate=0.5):
        super().__init__()
        self.feature_in_dim = feature_in_dim
        self.feature_out_dim = feature_out_dim
        self.require_image = require_image
        embed = default_size * (2 if require_image else 1)
        d = dropout_rate
        # the reference hard-codes 256 encoder channels (modelZoo.py:31);
        # conv5 takes them plus the image branch's default_size, which is
        # the reference's embed at default_size 256 and what the JAX
        # package infers at any other width
        self.encoder = ConvBlock(feature_in_dim, 256, 3, 1, 1, pool=True, dropout=d)
        if require_image:
            self.image_resnet_postprocess = FeatEmbedBlock(
                IMAGE_FEAT_DIM, default_size, dropout=d
            )
        self._add_trunk(256 + default_size * require_image, embed, embed,
                        feature_out_dim, d)

    def forward(self, x, feats=None):
        B, _, T = x.shape
        fourth = self.encoder(x)
        if self.require_image:
            # (B, T, 2000) per frame -> Linear/BN on (B*T, 2000) -> maxpool/2
            feat = _per_step(self.image_resnet_postprocess,
                             feats.reshape(B * T, -1), B, T)
            fourth = torch.cat([fourth, max_pool_time(feat)], dim=1)
        return self._trunk(fourth)


class regressor_fcn_bn_32_v2(_UNet32):
    """"v2": the text, projected to the full width, is one more step of the
    bottleneck, concatenated along time after conv7.

    The upsample that follows keeps only the first sixth.shape[2] steps of
    the doubled bottleneck, and the text's step is the last one, so the
    output never depends on the text (as in the reference and the JAX
    package); the branch still runs, so in train mode its BatchNorm
    statistics move as theirs do, and its gradient is zero."""

    def __init__(self, feature_in_dim, feature_out_dim, require_text=False,
                 default_size=256, dropout_rate=0.5):
        super().__init__()
        self.feature_in_dim = feature_in_dim
        self.feature_out_dim = feature_out_dim
        self.require_text = require_text
        embed = default_size * (2 if require_text else 1)
        d = dropout_rate
        self.encoder = ConvBlock(feature_in_dim, embed, 3, 1, 1, pool=True, dropout=d)
        if require_text:
            self.text_embeds_postprocess = FeatEmbedBlock(TEXT_EMBED_DIM, embed,
                                                          dropout=d)
        self._add_trunk(embed, embed, embed, feature_out_dim, d)

    def forward(self, x, feats=None):
        at_bottleneck = None
        if self.require_text:
            def at_bottleneck(seventh):
                feat = self.text_embeds_postprocess(feats)  # (B, embed)
                return torch.cat([seventh, feat[:, :, None]], dim=2)
        return self._trunk(self.encoder(x), at_bottleneck)


class regressor_fcn_bn_32_v4(_UNet32):
    """"v4": conv7 halves the channels when text is used; the text, tiled
    over the bottleneck's steps, fills the other half (channel concat)."""

    def __init__(self, feature_in_dim, feature_out_dim, require_text=False,
                 default_size=256, dropout_rate=0.5):
        super().__init__()
        self.feature_in_dim = feature_in_dim
        self.feature_out_dim = feature_out_dim
        self.require_text = require_text
        embed = default_size * (2 if require_text else 1)
        d = dropout_rate
        self.encoder = ConvBlock(feature_in_dim, embed, 3, 1, 1, pool=True, dropout=d)
        if require_text:
            self.text_embeds_postprocess = FeatEmbedBlock(TEXT_EMBED_DIM, embed // 2,
                                                          dropout=d)
        self._add_trunk(embed, embed, embed // (1 + int(require_text)),
                        feature_out_dim, d)

    def forward(self, x, feats=None):
        at_bottleneck = None
        if self.require_text:
            def at_bottleneck(seventh):
                B, _, Tb = seventh.shape
                feat = _per_step(self.text_embeds_postprocess, _tiled(feats, Tb), B, Tb)
                return torch.cat([seventh, feat], dim=1)
        return self._trunk(self.encoder(x), at_bottleneck)


class regressor_fcn_bn_32_v4_deeper(nn.Module):
    """"v4_deeper": conv8-10 and skip1-4 at the bottleneck.

    The reference computes skip2's output and never uses it
    (modelZoo.py:700-701), so conv8-10, the text branch, skip1 and skip2
    reach nothing: the output does not depend on the text.  In train mode
    they run all the same, in the reference's order, so their BatchNorm
    statistics move as the reference's and the JAX package's do (their
    gradients stay None); in eval mode they would move nothing and are
    skipped."""

    def __init__(self, feature_in_dim, feature_out_dim, require_text=False,
                 default_size=256, dropout_rate=0.5):
        super().__init__()
        self.feature_in_dim = feature_in_dim
        self.feature_out_dim = feature_out_dim
        self.require_text = require_text
        embed = default_size * (2 if require_text else 1)
        bottleneck = embed // (1 + int(require_text))
        d = dropout_rate
        self.encoder = ConvBlock(feature_in_dim, embed, 3, 1, 1, pool=True, dropout=d)
        self.conv5 = ConvBlock(embed, embed, 3, 1, 1, dropout=d)
        self.conv6 = ConvBlock(embed, embed, 3, 1, 1, dropout=d)
        self.conv7 = ConvBlock(embed, embed, 5, 2, 2, dropout=d)
        self.conv8 = ConvBlock(embed, embed, 3, 1, 1, dropout=d)
        self.conv9 = ConvBlock(embed, bottleneck, 3, 1, 1, dropout=d)
        self.conv10 = ConvBlock(bottleneck, bottleneck, 3, 1, 1, dropout=d)
        if require_text:
            self.text_embeds_postprocess = FeatEmbedBlock(TEXT_EMBED_DIM, embed // 2,
                                                          dropout=d)
        self.skip1 = ConvBlock(embed, embed, 3, 1, 1, dropout=d)
        self.skip2 = ConvBlock(embed, embed, 3, 1, 1, dropout=d)
        self.skip3 = ConvBlock(embed, embed, 3, 1, 1, dropout=d)
        self.skip4 = ConvBlock(embed, embed, 3, 1, 1, dropout=d)
        self.decoder = Decoder(embed, feature_out_dim, dropout=d)

    def _dead_branch(self, seventh, feats):
        eighth = self.conv8(seventh)
        ninth = self.conv9(eighth)
        ninth = self.conv10(ninth) + ninth
        if self.require_text:
            B, _, Tb = ninth.shape
            feat = _per_step(self.text_embeds_postprocess, _tiled(feats, Tb), B, Tb)
            ninth = torch.cat([ninth, feat], dim=1)
        self.skip2(self.skip1(ninth) + eighth)

    def forward(self, x, feats=None):
        fourth = self.encoder(x)
        fifth = self.conv5(fourth)
        sixth = self.conv6(fifth)
        seventh = self.conv7(sixth)
        if self.training:
            self._dead_branch(seventh, feats)

        sixth = upsample_repeat(seventh, sixth.shape[2]) + sixth
        sixth = self.skip3(sixth)
        fifth = sixth + fifth
        fifth = self.skip4(fifth)
        return self.decoder(fifth)


class regressor_fcn_bn_discriminator(nn.Module):
    """Motion discriminator: 7 stride-2 conv blocks D->64->64->32->32->16->
    16->8 then Conv1d(8->1, k3) (modelZoo.py:767-813), one ``nn.Sequential``
    named ``convs`` with the reference's indices (convs 1, 5, ..., 25 and
    29; BatchNorms 3, 7, ..., 27).  Takes motion deltas (B, D, T'); emits a
    per-position real/fake score map (B, 1, T'')."""

    def __init__(self, feature_in_dim, dropout_rate=0.5):
        super().__init__()
        self.feature_in_dim = feature_in_dim
        layers = []
        in_ch = feature_in_dim
        for ch in (64, 64, 32, 32, 16, 16, 8):
            layers += list(ConvBlock(in_ch, ch, 5, 2, 2, dropout=dropout_rate))
            in_ch = ch
        layers += [Dropout(dropout_rate), nn.Conv1d(in_ch, 1, 3, 1, 1)]
        self.convs = nn.Sequential(*layers)

    def forward(self, x):
        return self.convs(x)
