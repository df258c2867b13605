"""Host-side LR scheduling.

The reference constructs ReduceLROnPlateau(patience=1e6, factor=0.5,
min_lr=1e-5) for both G and D (train_gan.py:79,94) — with that patience it
never fires in a real run, but the mechanism is part of the contract, so
it is implemented; the trainer steps it each validation.
"""

from __future__ import annotations


class ReduceLROnPlateau:
    def __init__(
        self,
        init_lr: float,
        mode: str = "min",
        factor: float = 0.5,
        patience: int = 1_000_000,
        min_lr: float = 1e-5,
    ):
        self.lr = init_lr
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.best = None
        self.num_bad = 0
        self.sign = 1.0 if mode == "min" else -1.0

    def step(self, metric: float) -> float:
        """Update with a new metric; returns the (possibly reduced) lr."""
        if self.best is None or self.sign * metric < self.sign * self.best:
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr
