"""Plain reference of the deepest generator, ``regressor_fcn_bn_32_v4_deeper``
(the reference's modelZoo.py:557-710), its GAN steps and their operations.

Plain ``torch`` on ``models.py``'s frozen blocks (``ConvBlock``,
``FeatEmbedBlock``, ``Decoder``, ``Dropout``), nothing of the measured
package.  The class registers its children in modelZoo's order (encoder,
conv5-10, ``text_embeds_postprocess``, skip1-4, decoder), so
``models.init_default_`` draws the same seeded weights as any implementation
that draws them in that order, and ``gan.Steps.load`` maps a trainer's
parameters and buffers onto it one for one.  Importing this module registers
the class in ``models.GENERATORS``, where ``models.build_generator`` and
``counts.generator_flops`` find it.

modelZoo computes skip2's output and never uses it (:700-701), so conv8-10,
the text branch, skip1 and skip2 (the dead branch) reach no output and the
text changes nothing.  In train mode the branch runs between conv7 and the
upsample, as modelZoo orders it, so its dropout masks are drawn in that order
and its BatchNorm statistics move.  The text, (B, 512) per clip, is tiled over
the bottleneck's T/4 steps as (B * T/4, 512) rows before its Linear and
BatchNorm, as modelZoo tiles it.

Departures from modelZoo, none of which changes what the model computes:

  * in eval mode the dead branch is skipped: there it would draw no mask and
    move no statistic, and its output is dropped;
  * dropout masks come from ``models.Dropout``'s generator, as in
    ``models.py``.

No gradient reaches the dead branch's parameters, so ``Steps`` here records a
parameter that got none as zeros (the rule the harness applies to the
program's first gradients) and otherwise keeps ``gan.Steps``' rules;
``first_steps`` and ``replay_epochs`` are ``gan``'s over it.
``step_flops`` counts a G step with its forward in train mode.
"""

from __future__ import annotations

import torch
from torch import nn

from portbench.harness import counts
from portbench.reference import gan, models


class regressor_fcn_bn_32_v4_deeper(nn.Module):
    def __init__(self, feature_in_dim, feature_out_dim, require_text=False,
                 default_size=256, dropout_rate=0.5):
        super().__init__()
        self.require_text = require_text
        embed = default_size * (2 if require_text else 1)
        bottleneck = embed // (1 + int(require_text))
        d = dropout_rate
        self.encoder = models.ConvBlock(feature_in_dim, embed, 3, 1, 1, pool=True, dropout=d)
        self.conv5 = models.ConvBlock(embed, embed, 3, 1, 1, dropout=d)
        self.conv6 = models.ConvBlock(embed, embed, 3, 1, 1, dropout=d)
        self.conv7 = models.ConvBlock(embed, embed, 5, 2, 2, dropout=d)
        self.conv8 = models.ConvBlock(embed, embed, 3, 1, 1, dropout=d)
        self.conv9 = models.ConvBlock(embed, bottleneck, 3, 1, 1, dropout=d)
        self.conv10 = models.ConvBlock(bottleneck, bottleneck, 3, 1, 1, dropout=d)
        if require_text:
            self.text_embeds_postprocess = models.FeatEmbedBlock(models.TEXT_EMBED_DIM,
                                                                 embed // 2, dropout=d)
        self.skip1 = models.ConvBlock(embed, embed, 3, 1, 1, dropout=d)
        self.skip2 = models.ConvBlock(embed, embed, 3, 1, 1, dropout=d)
        self.skip3 = models.ConvBlock(embed, embed, 3, 1, 1, dropout=d)
        self.skip4 = models.ConvBlock(embed, embed, 3, 1, 1, dropout=d)
        self.decoder = models.Decoder(embed, feature_out_dim, dropout=d)

    def dead_branch(self, seventh, feats):
        """conv8-10, the text, skip1 and skip2: computed, then dropped."""
        eighth = self.conv8(seventh)
        ninth = self.conv9(eighth)
        ninth = self.conv10(ninth) + ninth
        if self.require_text:
            B, _, Tb = ninth.shape
            rows = feats[:, None, :].expand(B, Tb, feats.shape[1]).reshape(B * Tb, -1)
            feat = self.text_embeds_postprocess(rows).reshape(B, Tb, -1).transpose(1, 2)
            ninth = torch.cat([ninth, feat], dim=1)
        self.skip2(self.skip1(ninth) + eighth)

    def forward(self, x, feats=None):
        fourth = self.encoder(x)
        fifth = self.conv5(fourth)
        sixth = self.conv6(fifth)
        seventh = self.conv7(sixth)
        if self.training:
            self.dead_branch(seventh, feats)
        up = torch.repeat_interleave(seventh, 2, dim=2)[:, :, :sixth.shape[2]]
        sixth = self.skip3(up + sixth)
        fifth = self.skip4(sixth + fifth)
        return self.decoder(fifth)


models.GENERATORS.setdefault("regressor_fcn_bn_32_v4_deeper", regressor_fcn_bn_32_v4_deeper)


class Steps(gan.Steps):
    """``gan.Steps`` with a parameter that got no gradient in the G step
    recorded as zeros among the first gradients."""

    def g_step(self, x, y, f):
        x, y, f = self._in(x, y, f)
        self.G.train()
        self.D.eval()
        y_hat = self.G(x.transpose(1, 2), f)
        with torch.no_grad():
            score = self.D(gan.motion(y_hat))
        loss = gan.regression(self.cfg, y_hat, y) + torch.mean((score - 1.0) ** 2)
        self.g_opt.zero_grad(set_to_none=True)
        loss.backward()
        if "G" not in self.grads:
            self.grads["G"] = [torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
                               for p in self.G.parameters()]
        self.g_opt.step()
        return float(loss.detach())


def first_steps(cfg, seed, batches, device, dtype=torch.float64, tf32=False,
                half_batch=False):
    """``gan.first_steps`` over this module's ``Steps``."""
    with gan.precision(tf32):
        st = Steps(cfg, seed, device, dtype, half_batch)
        step = {"g": st.g_step, "d": st.d_step, "val": st.val_step}
        losses = [step[kind](*batches[kind]) for kind in batches]
        return {"losses": losses, "grads": st.grads, "changes": st.changes()}


def replay_epochs(cfg, state, epochs, device, dtype=torch.float64, tf32=False,
                  half_batch=False, batch_twice=False):
    """``gan.replay_epochs`` over this module's ``Steps``."""
    with gan.precision(tf32):
        st = Steps(cfg, 0, device, dtype, half_batch)
        st.load(state)
        step = {"g": st.g_step, "d": st.d_step, "val": st.val_step}
        losses = []
        for kind, arrays, B in epochs:
            n = arrays[0].shape[0] // B
            batch = [0 if batch_twice and bi == 1 else bi for bi in range(n)]
            out = [step[kind](*(None if a is None else a[b * B:(b + 1) * B] for a in arrays))
                   for b in batch]
            losses.append(sum(out) / len(out))
        return {"losses": losses, "grads": st.grads, "changes": st.changes()}


def generator_flops_train(cfg, B, T):
    """One train-mode generator forward on (B, Din, T) windows and (B, 512)
    text: the eval forward and the dead branch."""
    with torch.device("meta"):
        net = regressor_fcn_bn_32_v4_deeper(
            cfg["feature_in_dim"], cfg["feature_out_dim"], require_text=cfg["require_text"],
            default_size=cfg["default_size"], dropout_rate=cfg["dropout"]).train()
    feats = (B, models.TEXT_EMBED_DIM) if cfg["require_text"] else None
    return counts.layer_flops(net, (B, cfg["feature_in_dim"], T), feats)


def step_flops(cfg, kind, B, T):
    """``counts.step_flops`` with the G step's forward in train mode: the
    dead branch's forward counts once and its backward not at all, since no
    gradient reaches it; the backward twice the eval forward.  D and val
    steps run G in eval mode and count as ``counts.step_flops`` does."""
    if kind != "g":
        return counts.step_flops(cfg, kind, B, T)
    g = counts.generator_flops(cfg, B, T)
    return generator_flops_train(cfg, B, T) + 2 * g + counts.discriminator_flops(cfg, B, T)
