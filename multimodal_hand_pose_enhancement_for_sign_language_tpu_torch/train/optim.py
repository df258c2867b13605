"""The classifiers' optimizer registry (reference hyperparameters.py:4-6).

Counterpart of the JAX package's ``train/classifier.py`` registry, which
builds its optimizers from optax:

  * ``Adam``  -- ``add_decayed_weights(wd)`` then ``adam``: the decay is an
    L2 term added to the gradient before the moments, which is
    ``torch.optim.Adam(weight_decay=wd)``;
  * ``AdamW`` -- ``optax.adamw``: decoupled decay, ``torch.optim.AdamW``;
  * ``NAdam`` -- ``add_decayed_weights(wd)`` then ``optax.nadam``.  optax's
    NAdam is not ``torch.optim.NAdam`` (which schedules its momentum with
    a 0.96-power decay): ``OptaxNAdam`` below is optax's update.
"""

from __future__ import annotations

import torch


class OptaxNAdam(torch.optim.Optimizer):
    """optax's ``nadam`` (``scale_by_adam(nesterov=True)``) with an L2 decay
    added to the gradient first, as the JAX package chains it:

        g   <- g + wd * p
        m   <- b1 m + (1 - b1) g;     v <- b2 v + (1 - b2) g^2
        m^  =  b1 m / (1 - b1^(t+1)) + (1 - b1) g / (1 - b1^t)
        p   <- p - lr m^ / (sqrt(v / (1 - b2^t)) + eps)
    """

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g.add(p, alpha=group["weight_decay"])
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                t = state["step"]
                m, v = state["exp_avg"], state["exp_avg_sq"]
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = (m * (b1 / (1 - b1 ** (t + 1)))).add_(g, alpha=(1 - b1) / (1 - b1 ** t))
                denom = (v / (1 - b2 ** t)).sqrt_().add_(group["eps"])
                p.addcdiv_(m_hat, denom, value=-group["lr"])
        return loss


OPTIMIZERS = {
    "Adam": torch.optim.Adam,
    "AdamW": torch.optim.AdamW,
    "NAdam": OptaxNAdam,
}


def make_optimizer(name: str, params, learning_rate: float, weight_decay: float):
    """The optimizer ``name`` of the registry, as the JAX package builds it."""
    if name not in OPTIMIZERS:
        raise KeyError(f"unknown optimizer {name!r}; known: {sorted(OPTIMIZERS)}")
    return OPTIMIZERS[name](params, lr=learning_rate, weight_decay=weight_decay)
