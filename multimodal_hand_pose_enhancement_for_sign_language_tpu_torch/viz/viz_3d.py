"""3D skeleton frames to animated GIFs.

PyTorch-side counterpart of the JAX package's ``viz/viz_3d.py`` (the
reference's viz/viz_3d.py:25-98): each frame a matplotlib 3D line plot of
the skeleton's bones (``view_init(90, 90)``, axes hidden, 10 x 6 inches at
75 dpi), rendered in memory, converted to a palette image and collected
into a looping GIF ``{results_dir}/{clip_idx}.gif`` per clip.  The GIF's
``duration`` is the reference's ``len(frames) / frame_rate``, which PIL
reads as milliseconds a frame.  Clips are numpy arrays or tensors (moved
to the CPU).  matplotlib and PIL are imported inside the functions, so
importing the port needs neither; ``require`` refuses early, naming the
missing package.
"""

from __future__ import annotations

import importlib
import io
import os

import numpy as np
import torch

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data.io import mkdir
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops import skeleton

PACKAGES = ("matplotlib", "PIL")


def missing() -> list:
    """The packages of ``PACKAGES`` that cannot be imported here."""
    absent = []
    for name in PACKAGES:
        try:
            importlib.import_module(name)
        except ImportError:
            absent.append(name)
    return absent


def require() -> None:
    """Raise unless matplotlib and PIL import: GIFs need both.  The message
    names the missing package and ``--seqs_to_viz 0``, the CLIs' way to run
    without GIFs."""
    absent = missing()
    if absent:
        raise RuntimeError(
            f"rendering GIFs needs {' and '.join(absent)}, which cannot be imported "
            "here; install it or pass --seqs_to_viz 0 to render none")


def _host(clip) -> np.ndarray:
    if torch.is_tensor(clip):
        return clip.detach().cpu().numpy()
    return np.asarray(clip)


def plot_3d_lines(frame, structure=None, show=False):
    """Render one frame (150,) of joint coordinates as a 3D line plot."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    structure = structure or skeleton.get_skeletal_model_structure()
    fig = plt.figure(figsize=(10, 6))
    ax = plt.axes(projection="3d")
    ax._axis3don = False
    for bone in structure:
        j, e = bone[0], bone[1]
        ax.plot(
            [frame[j * 3], frame[e * 3]],
            [frame[j * 3 + 1], frame[e * 3 + 1]],
            zs=[frame[j * 3 + 2], frame[e * 3 + 2]],
        )
    ax.view_init(90, 90)
    if show:
        plt.show()
    return fig, ax


def viz_clip(clip, clip_idx, structure=None, frame_rate=2, results_dir="viz_results"):
    """One clip (T, 150) -> ``{results_dir}/{clip_idx}.gif``."""
    from PIL import Image
    import matplotlib.pyplot as plt

    clip = _host(clip)
    mkdir(results_dir)
    frames = []
    for frame_idx in range(clip.shape[0]):
        fig, _ = plot_3d_lines(clip[frame_idx, :], structure)
        buf = io.BytesIO()
        fig.savefig(buf, format="png", dpi=75)
        plt.close(fig)
        buf.seek(0)
        frames.append(Image.open(buf).convert("P"))
    out = os.path.join(results_dir, f"{clip_idx}.gif")
    frames[0].save(
        out,
        format="GIF",
        append_images=frames[1:],
        save_all=True,
        duration=len(frames) / frame_rate,
        loop=0,
    )
    return out


def viz(xyz, structure=None, frame_rate=2, results_dir="viz_results"):
    """Every clip of ``xyz`` -> the list of its GIF paths; a clip holding a
    NaN is refused (reference viz_3d.py:72-77)."""
    gifs_paths = []
    for clip_idx in range(len(xyz)):
        clip = _host(xyz[clip_idx])
        if np.isnan(clip).any():
            raise ValueError(f"clip {clip_idx} holds NaN")
        gifs_paths.append(viz_clip(clip, clip_idx, structure, frame_rate=frame_rate,
                                   results_dir=results_dir))
    return gifs_paths
