"""Plain reference of the GAN trainer's steps (the reference's
train_gan.py:200-330): generator, discriminator and validation steps, each
with Adam (lr from the configuration, PyTorch's default betas and eps, no
weight decay).  ``first_steps`` runs one of each from the seed;
``replay_epochs`` runs whole epochs, batch by batch, from a trainer's state
taken in the middle of training.

  * G step: G in train mode, D in eval mode; loss = regression(G(x), y) +
    mean((D(motion(G(x))) - 1)^2) with D's score under no_grad, so the
    adversarial term adds value and no gradient (train_gan.py:282-284);
  * D step: G in eval mode under no_grad; D in train mode on the fake motion
    then the real one; loss = mean(D(fake)^2) + mean((D(real) - 1)^2);
  * val step: G in eval mode, the regression loss.

motion(a) is a[:, :, :1] - a[:, :, :-1] on (B, D, T), as the reference
writes it.  The weights come from ``models.init_default_`` with the seed and
the seed + 1, the dropout masks from a ``torch.Generator`` on the device
seeded with the seed, drawn in the order the steps run; or all of these from
a state (``Steps.load``).  Plain torch; the dtype and TF32 switches are the
caller's.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

from portbench.reference import models, robust


def motion(a):
    return a[:, :, :1] - a[:, :, :-1]


def regression(cfg, y_hat_bdt, y):
    y_hat = y_hat_bdt.transpose(1, 2)
    if cfg["loss"] == "L1":
        return torch.mean(torch.abs(y_hat - y))
    if cfg["loss"] == "RobustLoss":
        return robust.robust_loss((y_hat - y).reshape(y.shape[0], -1))
    raise ValueError(f"no reference for loss {cfg['loss']!r}")


@contextmanager
def precision(tf32: bool):
    """TF32 for cuBLAS and cuDNN on (the control) or off, restored after."""
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


class Steps:
    """The reference trainer: seeded models, optimizers and dropout stream.
    ``half_batch`` plants a fault for the calibration: each step's loss is
    the mean over the first half of its batch.  ``grads`` keeps the first
    gradient each optimizer got."""

    def __init__(self, cfg, seed, device, dtype=torch.float64, half_batch=False):
        self.cfg, self.dtype, self.device = cfg, dtype, torch.device(device)
        self.half = half_batch
        self.G = models.build_generator(cfg, seed, dtype, device)
        self.D = models.build_discriminator(cfg, seed + 1, dtype, device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        models.set_dropout_generator(self.G, self.gen)
        models.set_dropout_generator(self.D, self.gen)
        lr = cfg["learning_rate"]
        self.g_opt = torch.optim.Adam(self.G.parameters(), lr=lr)
        self.d_opt = torch.optim.Adam(self.D.parameters(), lr=lr)
        self._mark()
        self.grads = {}

    def _mark(self):
        self.p0 = {"G": [p.detach().clone() for p in self.G.parameters()],
                   "D": [p.detach().clone() for p in self.D.parameters()]}

    def load(self, state):
        """Take a trainer's state: ``state["G"]`` / ``["D"]`` the modules'
        parameters then buffers, in module order; ``["g_opt"]`` /
        ``["d_opt"]`` each parameter's Adam (exp_avg, exp_avg_sq, step), or
        None where it holds none; ``["rng"]`` the dropout generator's state.
        The parameters' change is counted from here."""
        with torch.no_grad():
            for m, key in ((self.G, "G"), (self.D, "D")):
                for t, s in zip(list(m.parameters()) + list(m.buffers()), state[key],
                                strict=True):
                    t.copy_(s)
        for opt, m, key in ((self.g_opt, self.G, "g_opt"), (self.d_opt, self.D, "d_opt")):
            for p, s in zip(m.parameters(), state[key], strict=True):
                if s is not None:
                    avg, avg_sq, step = s
                    opt.state[p] = {"step": torch.tensor(float(step)),
                                    "exp_avg": avg.to(p), "exp_avg_sq": avg_sq.to(p)}
        self.gen.set_state(state["rng"])
        self._mark()

    def _in(self, *arrays):
        out = []
        for a in arrays:
            if a is None:
                out.append(None)
                continue
            t = torch.as_tensor(a).to(self.device, self.dtype)
            out.append(t[: t.shape[0] // 2] if self.half else t)
        return out

    def g_step(self, x, y, f):
        x, y, f = self._in(x, y, f)
        self.G.train()
        self.D.eval()
        y_hat = self.G(x.transpose(1, 2), f)
        with torch.no_grad():
            score = self.D(motion(y_hat))
        loss = regression(self.cfg, y_hat, y) + torch.mean((score - 1.0) ** 2)
        self.g_opt.zero_grad(set_to_none=True)
        loss.backward()
        if "G" not in self.grads:
            self.grads["G"] = [p.grad.detach().clone() for p in self.G.parameters()]
        self.g_opt.step()
        return float(loss.detach())

    def d_step(self, x, y, f):
        x, y, f = self._in(x, y, f)
        self.G.eval()
        self.D.train()
        with torch.no_grad():
            fake = self.G(x.transpose(1, 2), f)
        fake_score = self.D(motion(fake))
        real_score = self.D(motion(y.transpose(1, 2)))
        loss = torch.mean(fake_score ** 2) + torch.mean((real_score - 1.0) ** 2)
        self.d_opt.zero_grad(set_to_none=True)
        loss.backward()
        if "D" not in self.grads:
            self.grads["D"] = [p.grad.detach().clone() for p in self.D.parameters()]
        self.d_opt.step()
        return float(loss.detach())

    def val_step(self, x, y, f):
        x, y, f = self._in(x, y, f)
        self.G.eval()
        with torch.no_grad():
            return float(regression(self.cfg, self.G(x.transpose(1, 2), f), y))

    def changes(self):
        return {k: [p.detach() - q for p, q in zip(m.parameters(), self.p0[k])]
                for k, m in (("G", self.G), ("D", self.D))}


def first_steps(cfg, seed, batches, device, dtype=torch.float64, tf32=False,
                half_batch=False):
    """Run one step of each kind on ``batches`` = {"g": (x, y, f), "d": ...,
    "val": ...} (numpy, (B, T, D) layout), in the dict's order.  Returns
    {"losses": [one a step, in that order],
    "grads": {"G": [...], "D": [...]}, "changes": {"G": [...], "D": [...]}}
    with the gradients each optimizer got at its first step and the
    parameters' change after the three steps, leaf by leaf in parameter
    order."""
    with precision(tf32):
        st = Steps(cfg, seed, device, dtype, half_batch)
        step = {"g": st.g_step, "d": st.d_step, "val": st.val_step}
        losses = [step[kind](*batches[kind]) for kind in batches]
        return {"losses": losses, "grads": st.grads, "changes": st.changes()}


def replay_epochs(cfg, state, epochs, device, dtype=torch.float64, tf32=False,
                  half_batch=False, batch_twice=False):
    """Run ``epochs`` = [(kind, (X, Y, F), batch_size)] in order from a
    trainer's ``state`` (``Steps.load``), each batch by batch over its rows
    as ``GanTrainer.run_epoch`` takes them (the last incomplete batch
    dropped).  Returns {"losses": each epoch's mean batch loss,
    "grads": {"G"/"D": the first gradient each optimizer got},
    "changes": {"G"/"D": the parameters' change}}.  ``batch_twice`` plants a
    fault for the calibration: each epoch feeds its first batch again in
    place of its second."""
    with precision(tf32):
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
