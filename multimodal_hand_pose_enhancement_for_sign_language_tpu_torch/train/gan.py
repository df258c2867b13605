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
(``checkpoint_payload`` / ``load_checkpoint_payload`` carry it), all
float32 on one device.  ``compute_dtype="bfloat16"`` runs the models'
compute in bfloat16 as the JAX package's ``_cast_in`` / ``_cast_out`` do:
bfloat16 copies of the weights and running statistics for each step, the
new statistics written back as float32, the master weights and Adam's
state float32, the losses reduced in float32 on a float32 prediction.
``fused_d`` runs the D step's fake and real passes as one forward
(``_d_scores_fused``).  ``grad_flow`` reports the G loss's gradients
without a step.  Each step runs with TF32 off and cuDNN off, both restored
afterwards: the convolutions are PyTorch's own
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
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

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
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.viz import track_grads

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
D_MOMENTUM = 0.1  # every BatchNorm of the discriminator


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
    # the D step's fake and real passes as one forward, the sequential
    # running statistics recovered algebraically; off by default, as in the
    # JAX package
    fused_d: bool = False
    # "bfloat16": the models' compute in bfloat16 (weights, optimizer state
    # and losses stay float32)
    compute_dtype: str = "float32"


def _float32_step(fn):
    """Run a step with TF32 off for convs and matmuls and cuDNN off, then
    restore both.  At a bfloat16 compute dtype oneDNN is off too, so the
    CPU's convolutions are PyTorch's own as well: oneDNN's bfloat16
    convolution backward returns NaN weight gradients now and then
    (PyTorch 2.13 on the CPU: 4 of 30 D steps of tests/test_torch_options.py's
    batch), none with it off."""
    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        was = torch.backends.cudnn.enabled, torch.backends.mkldnn.enabled
        torch.backends.cudnn.enabled = False
        if self.dtype != torch.float32:
            torch.backends.mkldnn.enabled = False
        try:
            with conv_matmul_precision("float32"):
                return fn(self, *args, **kwargs)
        finally:
            torch.backends.cudnn.enabled, torch.backends.mkldnn.enabled = was
    return wrapped


class GanTrainer:
    """Builds the models, optimizers and loss on ``device`` and exposes the
    train/val steps.  Weights are PyTorch's default initialisation seeded
    from ``cfg.seed``; dropout masks come from a generator on the device
    seeded from it too, so nothing draws from the global generator."""

    def __init__(self, cfg: GanConfig, device="cuda"):
        if cfg.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: expected one of "
                             f"{sorted(_DTYPES)}")
        self.cfg = cfg
        self.dtype = _DTYPES[cfg.compute_dtype]
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
    # compute dtype (the JAX package's _cast_in / _cast_out)
    # ------------------------------------------------------------------
    def _cast(self, a):
        """An input at the compute dtype (``_cast_in``): bfloat16 under
        ``compute_dtype="bfloat16"``, else as given (None stays None)."""
        if a is None or self.dtype == torch.float32:
            return a
        return a.to(self.dtype)

    @staticmethod
    def _uncast(a):
        """A bfloat16 result as float32 (``_cast_out``); others as they are."""
        return a.float() if a.dtype == torch.bfloat16 else a

    @contextmanager
    def _at_compute_dtype(self, module):
        """Yields ``(forward, params, buffers)``: the module's forward, its
        parameters and its buffers by name at the compute dtype.  In float32
        these are the module and its own tensors.  In bfloat16, casts of
        them (the gradient reaches the float32 masters through the cast;
        integer buffers are the module's own); a module in train mode gets
        its new running statistics back as float32 on leaving, as
        ``_cast_out`` returns them."""
        if self.dtype == torch.float32:
            yield module, dict(module.named_parameters()), dict(module.named_buffers())
            return
        params = {n: p.to(self.dtype) for n, p in module.named_parameters()}
        bufs = {n: b.to(self.dtype) if b.is_floating_point() else b
                for n, b in module.named_buffers()}
        yield ((lambda *a: torch.func.functional_call(module, (params, bufs), a)),
               params, bufs)
        if module.training:
            with torch.no_grad():
                for n, b in module.named_buffers():
                    if b.is_floating_point():
                        b.copy_(bufs[n])

    # ------------------------------------------------------------------
    # steps: x (B, T, Din), y (B, T, Dout), feats on the trainer's device
    # ------------------------------------------------------------------
    def _g_loss(self, x, y, feats):
        """The generator's training loss (train-mode G, the adversarial term
        through an eval-mode D), shared by ``g_step`` and ``grad_flow``."""
        self.generator.train()
        self.discriminator.eval()
        with self._at_compute_dtype(self.generator) as (gen, _, _):
            y_hat = self._uncast(gen(self._cast(x.transpose(1, 2)), self._cast(feats)))
        fake_motion = self._cast(calc_motion(y_hat))
        with self._at_compute_dtype(self.discriminator) as (disc, _, _):
            if self.cfg.effective_gan:
                fake_score = self._uncast(disc(fake_motion))
            else:
                # reference quirk: score computed under no_grad
                with torch.no_grad():
                    fake_score = self._uncast(disc(fake_motion))
        return self._reg(y_hat, y) + mse(fake_score, 1.0)

    @_float32_step
    def g_step(self, x, y, feats=None):
        """One generator update; returns the loss (a 0-d device tensor)."""
        g_loss = self._g_loss(x, y, feats)
        self.g_opt.zero_grad(set_to_none=True)
        g_loss.backward(inputs=self._g_params)
        self.g_opt.step()
        return g_loss.detach()

    @_float32_step
    def d_step(self, x, y, feats=None):
        """One discriminator update; returns the loss.  G runs in eval mode
        under no_grad; D takes two train-mode forwards, fake then real, so
        its running statistics update twice in that order (with
        ``fused_d``, one forward over both and the same statistics)."""
        self.generator.eval()
        self.discriminator.train()
        with torch.no_grad(), self._at_compute_dtype(self.generator) as (gen, _, _):
            fake = gen(self._cast(x.transpose(1, 2)), self._cast(feats))
        fake_motion = calc_motion(fake)
        real_motion = self._cast(calc_motion(y.transpose(1, 2)))
        t_fake, t_real = (0.1, 0.9) if self.cfg.disc_label_smooth else (0.0, 1.0)
        with self._at_compute_dtype(self.discriminator) as (disc, params, bufs):
            if self.cfg.fused_d:
                fake_score, real_score = self._d_scores_fused(params, bufs, fake_motion,
                                                              real_motion)
            else:
                fake_score, real_score = disc(fake_motion), disc(real_motion)
        d_loss = mse(self._uncast(fake_score), t_fake) + mse(self._uncast(real_score), t_real)
        self.d_opt.zero_grad(set_to_none=True)
        d_loss.backward()
        self.d_opt.step()
        return d_loss.detach()

    def _d_scores_fused(self, params, bufs, fake_motion, real_motion):
        """D's train-mode forward of the fake and the real pass at once.
        Each block's conv runs on the 2B rows; each BatchNorm on the (B, 2C,
        T) view, the two passes as two channel groups with the weights
        repeated, so each normalizes by its own batch statistics, and both
        update copies of the same statistics s0.  The sequential update
        (fake, then real) is recovered as (1 - m) upd_fake + upd_real -
        (1 - m) s0 (the JAX package's fused D step, momentum m = 0.1).
        ``params``, ``bufs``: D's parameters and buffers by name at the
        compute dtype; the statistics in ``bufs`` are updated in place."""
        B = fake_motion.shape[0]
        h = torch.cat((fake_motion, real_motion))  # (2B, C, T)
        for i, layer in enumerate(self.discriminator.convs):
            if isinstance(layer, nn.Conv1d):
                h = F.conv1d(h, params[f"convs.{i}.weight"], params[f"convs.{i}.bias"],
                             layer.stride, layer.padding)
            elif isinstance(layer, nn.BatchNorm1d):
                _, C, T = h.shape
                s0 = (bufs[f"convs.{i}.running_mean"], bufs[f"convs.{i}.running_var"])
                upd = [torch.cat((s, s)) for s in s0]
                g = h.view(2, B, C, T).transpose(0, 1).reshape(B, 2 * C, T)
                g = F.batch_norm(g, upd[0], upd[1], params[f"convs.{i}.weight"].repeat(2),
                                 params[f"convs.{i}.bias"].repeat(2), True, D_MOMENTUM,
                                 layer.eps)
                h = g.view(B, 2, C, T).transpose(0, 1).reshape(2 * B, C, T)
                with torch.no_grad():
                    for s, u in zip(s0, upd):
                        f, r = u.view(2, C)
                        s.copy_((1 - D_MOMENTUM) * f + r - (1 - D_MOMENTUM) * s)
                    bufs[f"convs.{i}.num_batches_tracked"].add_(2)
            else:  # Dropout, LeakyReLU
                h = layer(h)
        return h[:B], h[B:]

    @_float32_step
    def val_step(self, x, y, feats=None):
        self.generator.eval()
        with torch.no_grad(), self._at_compute_dtype(self.generator) as (gen, _, _):
            y_hat = self._uncast(gen(self._cast(x.transpose(1, 2)), self._cast(feats)))
            return self._reg(y_hat, y)

    @_float32_step
    def grad_flow(self, x, y, feats=None) -> dict:
        """Per-parameter mean and max |g| of the G training loss's gradients
        on one batch, keyed by the generator's parameter names, without a
        step: the modules' weights, running statistics and dropout stream
        are as they were (dropout draws from a generator seeded 0, as the
        JAX package's grad_flow draws from PRNGKey(0))."""
        before = {n: b.clone() for n, b in self.generator.named_buffers()}
        set_dropout_generator(self.generator,
                              torch.Generator(device=self.device).manual_seed(0))
        try:
            loss = self._g_loss(x, y, feats)
            names = [n for n, _ in self.generator.named_parameters()]
            grads = torch.autograd.grad(loss, self._g_params, allow_unused=True)
        finally:
            set_dropout_generator(self.generator, self.dropout_generator)
            with torch.no_grad():
                for n, b in self.generator.named_buffers():
                    b.copy_(before[n])
        return track_grads.grad_flow_stats(
            {n: g for n, g in zip(names, grads) if g is not None})

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
