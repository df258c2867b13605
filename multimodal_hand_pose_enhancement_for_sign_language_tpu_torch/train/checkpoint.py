"""Checkpoint loading: reference ``.pth`` files and the JAX package's ``.pkl``.

A reference checkpoint is ``{'epoch', 'state_dict', 'g_optimizer'}``
(train_gan.py:353-370), already in this port's key layout.  A JAX-package
checkpoint is a pickle of ``{'epoch', 'state': {...}, 'config'}`` whose
``state`` also holds the optax optimizer state (optax NamedTuples) and the
PRNG key (a ``train.checkpoint._KeyData``).  A plain ``pickle.load`` would
import jax, optax and the JAX package to rebuild those; ``_NumpyUnpickler``
resolves numpy arrays and builtin containers only and turns every other
class into an inert stand-in, so only ``state.g_params`` and
``state.g_stats`` (plain dicts of numpy arrays) are read for real.
"""

from __future__ import annotations

import builtins
import collections
import copyreg
import pickle

import numpy as np
import torch

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models.convert import (
    generator_state_dict,
)

_SAFE_BUILTINS = frozenset({
    "dict", "list", "tuple", "set", "frozenset", "int", "float", "complex",
    "bool", "str", "bytes", "bytearray", "slice", "range", "object",
})
_NUMPY_MODULES = frozenset({
    "numpy", "numpy.core.multiarray", "numpy._core.multiarray",
    "numpy.core.numeric", "numpy._core.numeric",
})
_NUMPY_NAMES = frozenset({"_reconstruct", "ndarray", "dtype", "scalar", "_frombuffer"})


class Inert:
    """Stand-in for a pickled object of a class this port does not import.

    Keeps whatever the pickle gives it (constructor arguments, state) so a
    caller can inspect it, and runs no code of the original class."""

    def __new__(cls, *args, **kwargs):
        obj = super().__new__(cls)
        obj.args = args
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state


class _NumpyUnpickler(pickle.Unpickler):
    def __init__(self, f):
        super().__init__(f)
        self._inert: dict = {}

    def find_class(self, module, name):
        if module == "builtins" and name in _SAFE_BUILTINS:
            return getattr(builtins, name)
        if module == "collections" and name == "OrderedDict":
            return collections.OrderedDict
        if module == "copyreg" and name == "_reconstructor":
            return copyreg._reconstructor
        if module in _NUMPY_MODULES and name in _NUMPY_NAMES:
            if name in ("ndarray", "dtype"):
                return getattr(np, name)
            return super().find_class(module, name)
        if module == "numpy.dtypes":  # dtype classes of numpy >= 2
            return getattr(np.dtypes, name)
        key = (module, name)
        if key not in self._inert:
            self._inert[key] = type(name, (Inert,), {"__module__": module})
        return self._inert[key]


def load_jax_pickle(path: str) -> dict:
    """Read a JAX-package ``.pkl`` checkpoint without importing JAX."""
    with open(path, "rb") as f:
        return _NumpyUnpickler(f).load()


def load_generator_state(path: str) -> dict:
    """Generator state_dict (reference key layout, CPU tensors) from a
    reference ``.pth`` or a JAX-package ``.pkl`` checkpoint."""
    if path.endswith(".pth"):
        loaded = torch.load(path, map_location="cpu", weights_only=True)
        return dict(loaded["state_dict"])
    loaded = load_jax_pickle(path)
    if "state" not in loaded:
        raise KeyError(f"{path}: no 'state' entry; not a generator checkpoint")
    state = loaded["state"]
    return generator_state_dict(
        {"params": state["g_params"], "batch_stats": state["g_stats"]}
    )
