"""Plain reference of the LSTM topic classifier's training and evaluation
steps (the reference's H2Sclassifier/Model/ClassifLSTM.py:5-26,
Train_Test/train_epoch.py and val_epoch.py, main.py's Adam with
``hyperparameters.py``'s L2) and their operations.

Plain ``torch`` and ``math`` only: no ``nn.LSTM``, no cuDNN, nothing of the
measured package.  The weights are a list of tensors in ``nn.LSTM``'s order,
layer by layer: ``weight_ih``, ``weight_hh``, ``bias_ih``, ``bias_hh`` of the
forward direction, then of the reverse one; then the head's weight and
bias.  ``init_weights`` draws them from the seed in that order, as the port's
``init_classifier_`` does: every LSTM tensor U(-1/sqrt(H), 1/sqrt(H)), the
head PyTorch's default, each drawn as float32 on the CPU.

A layer and direction is one input projection, ``x @ W_ih.T + b_ih + b_hh``
over every timestep, then a loop over time of ``h @ W_hh.T`` added to the
step's projection and the gates in ``nn.LSTM``'s order (i, f, g, o; sigmoid,
sigmoid, tanh, sigmoid): ``c = f c + i g``, ``h = o tanh(c)``, from zero
states.  The reverse direction runs the same loop over the input reversed in
time and its outputs are reversed back; the two directions' outputs are
concatenated.  The two directions' loops run side by side, one batched
product a timestep for both.  Between layers, never after the last, dropout multiplies by a
mask drawn as ``torch.rand((B, T, 2H), generator, dtype=float32) < keep``
and divides by ``keep``, one mask a layer in the order the layers run, from
a ``torch.Generator`` in the trainer's state.  The head maps every
timestep to the classes; the loss is the cross-entropy of the last
timestep's logits against the labels shifted from 1-based to 0-based, a mean
over the rows.  Adam adds the L2 term ``wd * p`` to the gradient before its
moments (coupled, as ``torch.optim.Adam(weight_decay=wd)``).

A train step may run in row blocks: each block's loss is its rows' summed
cross-entropy over the whole batch's rows, so the blocks' losses and
gradients add up to the batch's; the masks are drawn for the whole batch
first and cut by rows.  The dtype and TF32 switches are the caller's
(``precision``).

Departures from the published description, none of which changes what the
model computes:

  * the masks come from a generator given to the step, drawn once for the
    batch before the forward, where the published model's ``nn.LSTM`` draws
    them inside the stacked call from the global generator;
  * the head's logits of every timestep are computed, as published, though
    only the last one's reach the loss.

``step_flops`` counts 2 x the multiply-adds of the input and recurrent
products and the head; a train step three times its forward.

Three faults for the calibration plant what a broken program would do: the
loss over the first half of each batch (``half_batch``), the masks drawn one
draw later in the stream (``shift_masks``), the reverse direction run over
the input in its own order (``unreversed``).
"""

from __future__ import annotations

import math

import torch

BETAS = (0.9, 0.999)
EPS = 1e-8
# rows a block of a train step: float64 activations of 64 rows fit beside
# the program's held state, float32 ones of a whole batch of 128
BLOCK_ROWS = {torch.float64: 64, torch.float32: 128}


class precision:
    """TF32 for cuBLAS and cuDNN on (the control) or off, restored after."""

    def __init__(self, tf32: bool):
        self.tf32 = tf32

    def __enter__(self):
        self.was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = self.tf32

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.was
        return False


def _dirs(cfg):
    return 2 if cfg["bidirectional"] else 1


def shapes(cfg):
    """The weights' shapes in their order."""
    H, dirs = cfg["hidden_size"], _dirs(cfg)
    out = []
    for k in range(cfg["num_layers"]):
        width = cfg["input_size"] if k == 0 else dirs * H
        out += [(4 * H, width), (4 * H, H), (4 * H,), (4 * H,)] * dirs
    return out + [(cfg["num_classes"], dirs * H), (cfg["num_classes"],)]


def init_weights(cfg, seed, dtype=torch.float64, device="cpu"):
    """The seeded weights: LSTM tensors U(-1/sqrt(H), 1/sqrt(H)), the head's
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), drawn as float32 on the CPU in order."""
    gen = torch.Generator().manual_seed(seed)
    all_shapes = shapes(cfg)
    n_lstm = len(all_shapes) - 2
    out = []
    for i, shape in enumerate(all_shapes):
        fan_in = cfg["hidden_size"] if i < n_lstm else all_shapes[-2][1]
        bound = 1.0 / math.sqrt(fan_in)
        vals = torch.rand(shape, generator=gen) * (2 * bound) - bound
        out.append(vals.to(device=device, dtype=dtype))
    return out


def _layer(x, weights, unreversed=False):
    """One layer over (B, T, width), its directions side by side:
    (B, T, dirs * H).  ``weights``: each direction's (W_ih, W_hh, b_ih,
    b_hh).  The reverse direction's input and output are reversed in time,
    unless ``unreversed`` (a fault)."""
    dirs = len(weights)
    B, T, _ = x.shape
    H = weights[0][1].shape[1]
    flip = [d > 0 and not unreversed for d in range(dirs)]
    proj = torch.stack([(x.flip(1) if f else x) @ w_ih.t() + b_ih + b_hh
                        for f, (w_ih, _, b_ih, b_hh) in zip(flip, weights)])
    # unbind: one backward node for all timesteps, where indexing would
    # make a zero-filled (dirs, B, T, 4H) gradient a step
    steps = proj.unbind(2)
    w = torch.stack([w_hh.t() for _, w_hh, _, _ in weights])  # (dirs, H, 4H)
    h = x.new_zeros(dirs, B, H)
    c = x.new_zeros(dirs, B, H)
    outs = []
    for t in range(T):
        gates = torch.baddbmm(steps[t], h, w)
        act = torch.sigmoid(gates)  # i, f and o; g's quarter is replaced by its tanh
        i, f, o = act[..., :H], act[..., H:2 * H], act[..., 3 * H:]
        g = torch.tanh(gates[..., 2 * H:3 * H])
        c = torch.addcmul(f * c, i, g)
        h = o * torch.tanh(c)
        outs.append(h)
    out = torch.stack(outs, 2)  # (dirs, B, T, H)
    return torch.cat([out[d].flip(1) if f else out[d] for d, f in enumerate(flip)], -1)


def forward(cfg, weights, x, masks=None, unreversed=False):
    """(B, T, input) -> (B, T, classes) logits; ``masks`` (one boolean
    (B, T, dirs * H) a layer but the last) for a train-mode forward."""
    dirs, L = _dirs(cfg), cfg["num_layers"]
    keep = 1.0 - cfg["dropout"]
    h = x
    for k in range(L):
        w = weights[4 * dirs * k: 4 * dirs * (k + 1)]
        h = _layer(h, [w[4 * d: 4 * d + 4] for d in range(dirs)], unreversed)
        if masks is not None and k < L - 1:
            h = h * masks[k].to(h.dtype) / keep
    return h @ weights[-2].t() + weights[-1]


def draw_masks(cfg, gen, B, T, device, shift=False):
    """The train-mode forward's masks for B rows, in the order the layers
    draw them; ``shift`` draws one number first (a fault)."""
    if cfg["dropout"] == 0.0:
        return None
    if shift:
        torch.rand(1, generator=gen, device=device, dtype=torch.float32)
    keep = 1.0 - cfg["dropout"]
    width = _dirs(cfg) * cfg["hidden_size"]
    return [torch.rand((B, T, width), generator=gen, device=device, dtype=torch.float32) < keep
            for _ in range(cfg["num_layers"] - 1)]


def _labels(y, device):
    return torch.as_tensor(y, dtype=torch.int64, device=device) - 1


class Trainer:
    """The reference trainer: weights, Adam's moments and step, and the
    dropout generator, on ``device`` at ``dtype``.  ``from_seed`` and
    ``from_state`` build one; ``train_step`` and ``eval_logits`` run the
    steps on host batches (x (B, T, input) float32, y 1-based)."""

    def __init__(self, cfg, weights, gen, device, dtype, faults=()):
        self.cfg, self.device, self.dtype = cfg, torch.device(device), dtype
        self.w = [t.requires_grad_(True) for t in weights]
        self.m = [torch.zeros_like(t) for t in self.w]
        self.v = [torch.zeros_like(t) for t in self.w]
        self.step = 0
        self.gen = gen
        self.faults = set(faults)
        self.w0 = [t.detach().clone() for t in self.w]
        self.first_grads = None

    @classmethod
    def from_seed(cls, cfg, seed, rng_state, device, dtype=torch.float64, faults=()):
        gen = torch.Generator(device=device)
        gen.set_state(rng_state)
        return cls(cfg, init_weights(cfg, seed, dtype, device), gen, device, dtype, faults)

    @classmethod
    def from_state(cls, cfg, state, device, dtype=torch.float64, faults=()):
        """A trainer's state: ``state["weights"]`` its parameters in order,
        ``["adam"]`` each one's (exp_avg, exp_avg_sq), ``["step"]`` Adam's
        step count, ``["rng"]`` the dropout generator's state."""
        gen = torch.Generator(device=device)
        gen.set_state(state["rng"])
        st = cls(cfg, [t.detach().to(device, dtype).clone() for t in state["weights"]], gen,
                 device, dtype, faults)
        with torch.no_grad():
            for m, v, (avg, avg_sq) in zip(st.m, st.v, state["adam"], strict=True):
                m.copy_(avg)
                v.copy_(avg_sq)
        st.step = int(state["step"])
        return st

    def _in(self, x):
        return torch.as_tensor(x).to(self.device, self.dtype)

    def eval_logits(self, x):
        """The last timestep's logits of an eval-mode forward."""
        with torch.no_grad():
            return forward(self.cfg, self.w, self._in(x),
                           unreversed="unreversed" in self.faults)[:, -1]

    def train_step(self, x, y, block_rows=None):
        """One update on the batch; returns the loss (a float).  The first
        step's gradients (before the L2 term) are kept as ``first_grads``."""
        B, T = x.shape[0], x.shape[1]
        block_rows = block_rows or BLOCK_ROWS[self.dtype]
        masks = draw_masks(self.cfg, self.gen, B, T, self.device,
                           shift="shift_masks" in self.faults)
        labels = _labels(y, self.device)
        rows = B // 2 if "half_batch" in self.faults else B
        for t in self.w:
            t.grad = None
        loss = 0.0
        for lo in range(0, rows, block_rows):
            sl = slice(lo, min(lo + block_rows, rows))
            logits = forward(self.cfg, self.w, self._in(x[sl]),
                             None if masks is None else [m[sl] for m in masks],
                             unreversed="unreversed" in self.faults)[:, -1]
            part = torch.nn.functional.cross_entropy(logits, labels[sl], reduction="sum") / rows
            part.backward()
            loss += float(part.detach())
        if self.first_grads is None:
            self.first_grads = [t.grad.detach().clone() for t in self.w]
        self._adam()
        return loss

    @torch.no_grad()
    def _adam(self):
        lr, wd = self.cfg["learning_rate"], self.cfg["weight_decay"]
        b1, b2 = BETAS
        self.step += 1
        c1, c2 = 1 - b1 ** self.step, 1 - b2 ** self.step
        for p, m, v in zip(self.w, self.m, self.v):
            g = p.grad.add(p, alpha=wd)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v.sqrt() / math.sqrt(c2)).add_(EPS)
            p.addcdiv_(m, denom, value=-lr / c1)

    def changes(self):
        return [(p.detach() - q) for p, q in zip(self.w, self.w0)]


def first_steps(cfg, seed, rng_state, train_batch, val_batch, device, dtype=torch.float64,
                tf32=False, faults=()):
    """One train step from the seeded weights on ``train_batch`` (x, y),
    then the eval-mode logits of ``val_batch``'s x.  Returns {"loss",
    "grads" (the step's gradients), "changes" (the weights' change),
    "logits" (the last timestep's)}."""
    with precision(tf32):
        st = Trainer.from_seed(cfg, seed, rng_state, device, dtype, faults)
        loss = st.train_step(*train_batch)
        return {"loss": loss, "grads": st.first_grads, "changes": st.changes(),
                "logits": st.eval_logits(val_batch[0])}


def replay_epoch(cfg, state, X, Y, batch_size, device, dtype=torch.float64, tf32=False,
                 faults=()):
    """One train epoch from a trainer's ``state`` (``Trainer.from_state``):
    every whole batch of (X, Y) in order.  ``"batch_twice"`` in ``faults``
    feeds the first batch again in place of the second.  Returns {"losses"
    (one a step), "grads" (the first step's), "changes"}."""
    with precision(tf32):
        st = Trainer.from_state(cfg, state, device, dtype, faults)
        n = X.shape[0] // batch_size
        order = [0 if "batch_twice" in faults and b == 1 else b for b in range(n)]
        losses = [st.train_step(X[b * batch_size:(b + 1) * batch_size],
                                Y[b * batch_size:(b + 1) * batch_size]) for b in order]
        return {"losses": losses, "grads": st.first_grads, "changes": st.changes()}


def forward_flops(cfg, B, T):
    """2 x the multiply-adds of one forward over (B, T, input): per layer and
    direction the input projection and T recurrent products, then the head
    over every timestep."""
    H, dirs = cfg["hidden_size"], _dirs(cfg)
    total = 0
    for k in range(cfg["num_layers"]):
        width = cfg["input_size"] if k == 0 else dirs * H
        total += dirs * 2 * B * T * 4 * H * (width + H)
    return total + 2 * B * T * dirs * H * cfg["num_classes"]


def step_flops(cfg, kind, B, T):
    """A train step three times its forward (the backward twice), an eval
    step its forward."""
    if kind == "train":
        return 3 * forward_flops(cfg, B, T)
    if kind == "eval":
        return forward_flops(cfg, B, T)
    raise ValueError(f"unknown step kind {kind!r}")
