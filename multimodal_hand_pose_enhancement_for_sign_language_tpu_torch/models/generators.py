"""The "v1" generator, ``regressor_fcn_bn_32``, its decoder, and the motion
discriminator.

PyTorch counterpart of the JAX package's ``models/generators.py``
(:46-106 and :273-287), which re-implements the reference
modelZoo.py:169-328 and :767-813.  Child
names and ``nn.Sequential`` indices are the reference's, so reference
``.pth`` checkpoints and the JAX package's converted weights load with
``strict=True``.  Input and output are (B, D, T).
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


class regressor_fcn_bn_32(nn.Module):
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
        self.conv5 = ConvBlock(embed, embed, 3, 1, 1, dropout=d)
        self.conv6 = ConvBlock(embed, embed, 3, 1, 1, dropout=d)
        self.conv7 = ConvBlock(embed, embed, 5, 2, 2, dropout=d)
        self.skip4 = ConvBlock(embed, embed, 3, 1, 1, dropout=d)
        self.skip5 = ConvBlock(embed, embed, 3, 1, 1, dropout=d)
        self.decoder = Decoder(embed, feature_out_dim, dropout=d)

    def forward(self, x, feats=None):
        B, _, T = x.shape
        fourth = self.encoder(x)
        if self.require_text:
            # (B, E) -> tile over T -> Linear/BN on (B*T, E) -> maxpool/2
            text = feats[:, None, :].expand(B, T, feats.shape[-1])
            feat = self.text_embeds_postprocess(text.reshape(B * T, -1))
            feat = max_pool_time(feat.reshape(B, T, -1).transpose(1, 2))
            fourth = torch.cat([fourth, feat], dim=1)

        fifth = self.conv5(fourth)
        sixth = self.conv6(fifth)
        seventh = self.conv7(sixth)

        sixth = upsample_repeat(seventh, sixth.shape[2]) + sixth
        sixth = self.skip4(sixth)
        fifth = sixth + fifth
        fifth = self.skip5(fifth)
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
