"""The GAN training engine: eager G/D/val steps + epoch loops.

PyTorch counterpart of the JAX package's ``train/gan.py``, the faithful
re-design of the reference train_gan.py:

  * schedule -- epoch 0 trains G; epoch > 0 with epoch % epochs_train_disc
    == 0 trains D; all other epochs train G then validate at half batch
    size (:102-112, :317); the CLI (``train_gan.py``) drives it,
  * ``calc_motion`` exactly as written -- first frame minus each of the
    first T-1 frames, NOT adjacent deltas (:209-211),
  * LSGAN MSE with optional 0.9/0.1 label smoothing (:242-247),
  * the generator's adversarial term uses a no_grad D score (:282-284) so it
    contributes value but ZERO gradient; pass effective_gan=True for a real
    adversarial gradient (extension, off by default),
  * RobustLoss latents exist but are in no optimizer (:69, :76-78),
  * Adam(lr, wd=0) for G and for D.

The public layout is the JAX package's: steps and epoch loops take
x (B, T, Din) and y (B, T, Dout), and for a conditioned generator feats,
text (B, 512) or image features (B, T, 2000), which only the generator
sees; a batch is transposed on the device for the (B, D, T) models.  The
trainer holds its state in its modules and optimizers
(``checkpoint_payload`` / ``load_checkpoint_payload`` carry it).
Everything is float32 on one device.  Each step runs with TF32 off and
cuDNN off, both restored afterwards: the convolutions are PyTorch's own
CUDA ones.  On an H100 cuDNN runs the 512-channel convolutions as FFTs,
each such layer's output 2.4-6.1 times as far from float64 as PyTorch's
own;
on these ill-conditioned steps that leaves some gradients up to 11491
times as far from a float64 step as the CPU's, and a G step takes up to
4.8 times as long (PERF.md, ``chip_step_precision.py``).  With
``loss="RobustLoss"`` the regression loss of every G and val step on a CUDA
device runs through the hand-written ``ops/robust_loss`` kernel.
"""

from __future__ import annotations

import copy
import functools
from dataclasses import dataclass

import numpy as np
import torch

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch import losses as losses_lib
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.infer import (
    conv_matmul_precision,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.losses.robust import (
    AdaptiveLossFunction,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models import registry
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models.layers import (
    set_dropout_generator,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops.robust_loss import (
    robust_lossfun,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.train.staging import (
    as_staged,
    unflatten_batch,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.device import (
    resolve_device,
)


def calc_motion(tensor_bdt):
    """Temporal 'motion' exactly as the reference computes it
    (train_gan.py:209-211), on (B, D, T): first frame minus each of the
    first T-1 frames."""
    return tensor_bdt[:, :, :1] - tensor_bdt[:, :, :-1]


def mse(a, target: float):
    return torch.mean(torch.square(a - target))


@dataclass
class GanConfig:
    model: str = "v1"
    pipeline: str = "arm2wh"
    feature_in_dim: int = 36
    feature_out_dim: int = 252
    batch_size: int = 128
    learning_rate: float = 1e-4
    num_epochs: int = 200
    patience: int = 100
    epochs_train_disc: int = 3
    disc_label_smooth: bool = False
    loss: str = "L1"
    require_text: bool = False
    require_image: bool = False
    default_size: int = 256
    seed: int = 23456
    effective_gan: bool = False  # extension: real adversarial gradient
    window_t: int = 192
    # reference hard-codes Dropout(0.5); 0.0 disables dropout everywhere
    # (train-step parity tests / ablations)
    dropout_rate: float = 0.5


def _float32_step(fn):
    """Run a step with TF32 off for convs and matmuls and cuDNN off, then
    restore both."""
    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        was = torch.backends.cudnn.enabled
        torch.backends.cudnn.enabled = False
        try:
            with conv_matmul_precision("float32"):
                return fn(self, *args, **kwargs)
        finally:
            torch.backends.cudnn.enabled = was
    return wrapped


class GanTrainer:
    """Builds the models, optimizers and loss on ``device`` and exposes the
    train/val steps.  Weights are PyTorch's default initialisation seeded
    from ``cfg.seed``; dropout masks come from a generator on the device
    seeded from it too, so nothing draws from the global generator."""

    def __init__(self, cfg: GanConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.generator = registry.build_generator(
            cfg.model, cfg.feature_in_dim, cfg.feature_out_dim,
            require_text=cfg.require_text, require_image=cfg.require_image,
            default_size=cfg.default_size, dropout_rate=cfg.dropout_rate,
            seed=cfg.seed, device=self.device,
        )
        self.discriminator = registry.build_discriminator(
            cfg.feature_out_dim, dropout_rate=cfg.dropout_rate,
            seed=cfg.seed + 1, device=self.device,
        )
        self.dropout_generator = torch.Generator(device=self.device)
        self.dropout_generator.manual_seed(cfg.seed)
        set_dropout_generator(self.generator, self.dropout_generator)
        set_dropout_generator(self.discriminator, self.dropout_generator)
        self._g_params = list(self.generator.parameters())
        self.g_opt = torch.optim.Adam(self._g_params, lr=cfg.learning_rate)
        self.d_opt = torch.optim.Adam(self.discriminator.parameters(),
                                      lr=cfg.learning_rate)
        if cfg.loss == "RobustLoss":
            # parameters that no optimizer holds (the reference's quirk)
            self.adaptive = AdaptiveLossFunction(
                num_dims=cfg.feature_out_dim * cfg.window_t).to(self.device)
            self.reg_loss = None
        else:
            self.adaptive = None
            self.reg_loss = losses_lib.get_loss(cfg.loss)

    # ------------------------------------------------------------------
    # losses
    # ------------------------------------------------------------------
    def _reg(self, y_hat_bdt, y):
        """Regression loss of a (B, Dout, T) prediction against y (B, T, Dout)."""
        y_hat = y_hat_bdt.transpose(1, 2)
        if self.adaptive is None:
            return self.reg_loss(y_hat, y)
        # (B, T * Dout) in the JAX package's order, column t * Dout + d, so
        # the per-column latents keep their meaning across the two packages
        resid = (y_hat - y).reshape(y.shape[0], -1)
        with torch.no_grad():  # the latents are held constant
            alpha = self.adaptive.alpha()
            scale = self.adaptive.scale()
            log_partition = self.adaptive.log_partition(alpha, scale)
        return torch.mean(robust_lossfun(resid, alpha, scale) + log_partition)

    # ------------------------------------------------------------------
    # steps: x (B, T, Din), y (B, T, Dout), feats on the trainer's device
    # ------------------------------------------------------------------
    @_float32_step
    def g_step(self, x, y, feats=None):
        """One generator update; returns the loss (a 0-d device tensor)."""
        self.generator.train()
        self.discriminator.eval()
        y_hat = self.generator(x.transpose(1, 2), feats)
        fake_motion = calc_motion(y_hat)
        if self.cfg.effective_gan:
            fake_score = self.discriminator(fake_motion)
        else:
            # reference quirk: score computed under no_grad
            with torch.no_grad():
                fake_score = self.discriminator(fake_motion)
        g_loss = self._reg(y_hat, y) + mse(fake_score, 1.0)
        self.g_opt.zero_grad(set_to_none=True)
        g_loss.backward(inputs=self._g_params)
        self.g_opt.step()
        return g_loss.detach()

    @_float32_step
    def d_step(self, x, y, feats=None):
        """One discriminator update; returns the loss.  G runs in eval mode
        under no_grad; D takes two sequential train-mode forwards, fake then
        real, so its running statistics update twice in that order."""
        self.generator.eval()
        self.discriminator.train()
        with torch.no_grad():
            fake = self.generator(x.transpose(1, 2), feats)
        fake_motion = calc_motion(fake)
        real_motion = calc_motion(y.transpose(1, 2))
        t_fake, t_real = (0.1, 0.9) if self.cfg.disc_label_smooth else (0.0, 1.0)
        fake_score = self.discriminator(fake_motion)
        real_score = self.discriminator(real_motion)
        d_loss = mse(fake_score, t_fake) + mse(real_score, t_real)
        self.d_opt.zero_grad(set_to_none=True)
        d_loss.backward()
        self.d_opt.step()
        return d_loss.detach()

    @_float32_step
    def val_step(self, x, y, feats=None):
        self.generator.eval()
        with torch.no_grad():
            y_hat = self.generator(x.transpose(1, 2), feats)
            return self._reg(y_hat, y)

    def _step(self, kind):
        return {"g": self.g_step, "d": self.d_step, "val": self.val_step}[kind]

    # ------------------------------------------------------------------
    # epoch loops
    # ------------------------------------------------------------------
    def run_epoch(self, X, Y, kind: str, batch_size: int, feats=None) -> float:
        """One pass over (N, T, D)-layout numpy arrays (and the features of
        the same rows), batch by batch from the host.  Drops the last
        incomplete batch (reference integer-division semantics).  The batch
        losses stay on the device; their mean is read once, at the end of
        the epoch."""
        step = self._step(kind)
        losses = []
        for bi in range(X.shape[0] // batch_size):
            sl = slice(bi * batch_size, (bi + 1) * batch_size)
            x, y, f = (None if a is None else
                       torch.from_numpy(np.ascontiguousarray(a[sl])).to(self.device)
                       for a in (X, Y, feats))
            losses.append(step(x, y, f))
        return float(torch.stack(losses).mean()) if losses else 0.0

    def stage(self, *arrays):
        """Move full (N, ...) arrays -- X, Y and the features, if any -- to
        the device once, for resident epochs; returns one Staged record per
        array (None stays None)."""
        return tuple(as_staged(a, self.device) for a in arrays)

    def run_epoch_resident(self, X_dev, Y_dev, perm, kind: str,
                           batch_size: int, F_dev=None) -> float:
        """Epoch over staged device data (and features, gathered like X)
        with a host-provided permutation (pass np.arange(N) for no shuffle,
        e.g. validation): only the permutation crosses to the device; each
        batch is gathered there."""
        staged = [as_staged(a, self.device) for a in (X_dev, Y_dev, F_dev)]
        nb = staged[0].dev.shape[0] // batch_size
        if nb == 0:
            return 0.0
        step = self._step(kind)
        perm = torch.as_tensor(np.asarray(perm)[: nb * batch_size],
                               dtype=torch.int64).to(self.device)
        losses = []
        for idx in perm.reshape(nb, batch_size):
            x, y, f = (None if a is None else
                       unflatten_batch(a.dev.index_select(0, idx), a.trail)
                       for a in staged)
            losses.append(step(x, y, f))
        return float(torch.stack(losses).mean())

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    def checkpoint_payload(self, epoch: int) -> dict:
        """Everything a resume needs.  The first three keys are the
        reference's generator checkpoint ({'epoch', 'state_dict',
        'g_optimizer'}, train_gan.py:353-370)."""
        return {
            "epoch": int(epoch),
            "state_dict": self.generator.state_dict(),
            "g_optimizer": self.g_opt.state_dict(),
            "discriminator": self.discriminator.state_dict(),
            "d_optimizer": self.d_opt.state_dict(),
            "robust": self.adaptive.state_dict() if self.adaptive is not None else {},
            "dropout_generator": self.dropout_generator.get_state(),
        }

    def load_checkpoint_payload(self, payload: dict) -> None:
        self.generator.load_state_dict(payload["state_dict"], strict=True)
        self.discriminator.load_state_dict(payload["discriminator"], strict=True)
        # an optimizer adopts the tensors it is given: copy, so a payload
        # handed over in memory does not tie two trainers' moments together
        self.g_opt.load_state_dict(copy.deepcopy(payload["g_optimizer"]))
        self.d_opt.load_state_dict(copy.deepcopy(payload["d_optimizer"]))
        if self.adaptive is not None:
            self.adaptive.load_state_dict(payload["robust"], strict=True)
        self.dropout_generator.set_state(payload["dropout_generator"].cpu())
