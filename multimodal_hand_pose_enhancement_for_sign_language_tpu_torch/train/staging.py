"""Device-resident dataset staging records for the trainer.

Counterpart of the JAX package's ``train/staging.py``.  A staged operand is
the whole (N, ...) array on the device, flattened to (N, prod(trail)), with
the per-sample shape beside it; a gathered batch is reshaped back to
(B,) + trail.  The JAX package flattens to spare the TPU its lane padding;
here the flat form is a view that costs nothing and keeps the two
trainers' interfaces the same.
"""

from __future__ import annotations

import numpy as np
import torch


class Staged(tuple):
    """(dev, trail): the (N, prod(trail))-flattened device tensor plus the
    original per-sample shape."""

    __slots__ = ()

    def __new__(cls, dev, trail):
        return tuple.__new__(cls, (dev, tuple(trail)))

    @property
    def dev(self):
        return self[0]

    @property
    def trail(self):
        return self[1]


def flatten_rows(a):
    """Host array or tensor (N, ...) -> (N, -1) plus the trailing shape."""
    a = a if isinstance(a, torch.Tensor) else np.asarray(a)
    trail = tuple(a.shape[1:])
    return a.reshape(a.shape[0], -1), trail


def as_staged(a, device):
    """Normalize a resident-epoch operand: pass Staged through, put a raw
    (N, ...) array on ``device``."""
    if a is None or isinstance(a, Staged):
        return a
    flat, trail = flatten_rows(a)
    return Staged(torch.as_tensor(flat).to(device), trail)


def unflatten_batch(x, trail):
    """Reshape a gathered (B, prod(trail)) batch back to (B,) + trail."""
    if trail is None or tuple(x.shape[1:]) == tuple(trail):
        return x
    return x.reshape((x.shape[0],) + tuple(trail))
