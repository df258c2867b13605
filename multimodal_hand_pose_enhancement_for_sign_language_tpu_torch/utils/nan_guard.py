"""NaN detection for the port.

PyTorch counterpart of the JAX package's ``utils/nan_guard.py``: the
reference's inline host asserts (train_gan.py:162, inference.py:70,133),
PyTorch's anomaly mode, and a per-leaf report over a nested state (a
``state_dict``, the gradients, an optimizer's state).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch


def _host(a) -> np.ndarray:
    if torch.is_tensor(a):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            a = a.float()
        return a.numpy()
    return np.asarray(a)


def assert_finite(name: str, *arrays) -> None:
    """Host-side NaN/Inf assert matching the reference's inline asserts;
    numpy arrays or tensors (moved to the CPU)."""
    for i, a in enumerate(arrays):
        a = _host(a)
        if not np.isfinite(a).all():
            bad = int((~np.isfinite(a)).sum())
            raise AssertionError(f"{name}[{i}]: {bad}/{a.size} non-finite values")


def enable_debug_nans(enable: bool = True) -> None:
    """Turn PyTorch's anomaly mode on or off
    (``torch.autograd.set_detect_anomaly``).  Unlike the JAX package's
    ``jax_debug_nans``, which raises at any operation that makes a NaN,
    forward or not, anomaly mode raises in the backward pass, naming the
    forward operation whose gradient came out NaN; a NaN made in a forward
    pass with no backward goes unreported (``assert_finite`` catches it)."""
    torch.autograd.set_detect_anomaly(enable)


def _leaves(tree, path=()):
    """(path, leaf) of a nested dict / list / tuple in the order JAX's
    ``tree_flatten_with_path`` visits it: a dict's keys sorted (an
    ``OrderedDict``'s, such as a ``state_dict``, in their order), a
    sequence's items in order, named ``[i]`` as JAX names them; None is an
    empty subtree, as in JAX."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in (tree if isinstance(tree, OrderedDict) else sorted(tree)):
            yield from _leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (f"[{i}]",))
    else:
        yield path, tree


def tree_check_finite(tree) -> dict:
    """{"a/b/[0]": number of non-finite entries} for every leaf of a nested
    dict / list / tuple of tensors or arrays that holds any; the names are
    those the JAX package's function gives for the same nesting."""
    report = {}
    for path, leaf in _leaves(tree):
        n_bad = int((~np.isfinite(_host(leaf))).sum())
        if n_bad:
            report["/".join(path)] = n_bad
    return report
