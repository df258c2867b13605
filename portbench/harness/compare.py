"""The comparisons that decide ``correct``: gaps between what the program
produced and what the plain reference works out from the same inputs."""

from __future__ import annotations

import numpy as np
import torch

# a leaf whose reference gradient is under this share of the median leaf's
# moves under Adam by round-off alone, and is left out of the change
NOUGHT_SHARE = 1e-3


def _norm(t):
    return float(torch.linalg.vector_norm(torch.as_tensor(t).double()))


def worst_leaf(prog, ref, ref_grads):
    """max over leaves of |norm(prog) - norm(ref)| / max(norm(ref), the
    median leaf's norm(ref)), leaves given as lists in the same order; a leaf
    whose reference gradient is under NOUGHT_SHARE of the median leaf's is
    left out."""
    g = np.array([_norm(t) for t in ref_grads])
    r = np.array([_norm(t) for t in ref])
    p = np.array([_norm(t) for t in prog])
    keep = g >= NOUGHT_SHARE * np.median(g)
    gaps = np.abs(p - r) / np.maximum(r, np.median(r))
    gaps[~keep] = 0.0
    return float(gaps.max())


def relative_max(got, want):
    """max |got - want| / max |want| over arrays of one shape."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def mpjpe(a, b):
    """Mean per-joint position error of two (T, 150) xyz clips."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm((a - b).reshape(-1, 50, 3), axis=-1).mean())


def judged(checks, limits):
    """{name: {"value": v, "limit": l}} and whether every value is finite
    and within its limit (a number without a limit fails)."""
    out, ok = {}, True
    for name, value in checks:
        limit = limits.get(name)
        out[name] = {"value": value, "limit": limit}
        ok = ok and limit is not None and np.isfinite(value) and value <= limit
    return out, ok
