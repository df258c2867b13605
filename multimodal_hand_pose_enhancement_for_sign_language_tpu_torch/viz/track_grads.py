"""Gradient-flow inspection for a trainer's gradients.

PyTorch counterpart of the JAX package's ``viz/track_grads.py`` (the
reference's viz/track_grads.py:9-40, a per-layer mean/max |gradient| bar
chart), on gradients keyed by parameter name (``encoder.1.weight``, ...).
"""

from __future__ import annotations

import numpy as np


def grad_flow_stats(grads) -> dict:
    """{name: gradient tensor} -> {name: {"ave": mean |g|, "max": max |g|}}."""
    stats = {}
    for name, g in grads.items():
        a = g.detach().abs().float()
        stats[name] = {"ave": float(a.mean()), "max": float(a.max())}
    return stats


def plot_grad_flow(grads, out_path="grad_flow.png"):
    """Bar chart of the gradient flow over the weights (the reference's
    filter: names ending in ``weight``, BatchNorm scales included), written
    to ``out_path``.  Needs matplotlib, imported here."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    stats = {k: v for k, v in grad_flow_stats(grads).items() if k.endswith("weight")}
    names = list(stats)
    ave = [stats[n]["ave"] for n in names]
    mx = [stats[n]["max"] for n in names]
    fig, ax = plt.subplots(figsize=(max(6, len(names) * 0.4), 5))
    x = np.arange(len(names))
    ax.bar(x, mx, alpha=0.4, lw=1, color="c", label="max-gradient")
    ax.bar(x, ave, alpha=0.7, lw=1, color="b", label="mean-gradient")
    ax.set_xticks(x)
    ax.set_xticklabels(names, rotation=90, fontsize=6)
    ax.set_ylabel("average gradient")
    ax.set_title("Gradient flow")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
    return out_path
