"""Single-clip 2D->3D lifting demo of the port: the root ``demo.py``.

    python -m multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.demo \\
        [--input SEQ.h5|SEQ.npy] [--out_dir demo_out] [--device cuda]

The reference demo's pipeline (3DposeEstimator/demo.py:27-92): load a
(T, 150) OpenPose sequence -> normalization -> prune -> interpolation ->
initialization (the engine's per-clip RandomState(1234) root noise) ->
backpropagation-based filtering v2, the single-clip API, whose filter is
``ops/filter_sgd`` (the CUDA kernel on the card) -> the txt dumps
``demo1.txt`` ... ``demo5.txt`` in the reference's format.  An ``.h5`` input
needs ``h5py`` (its first dataset), an ``.npy`` one is read
with numpy; without an input the root demo's seeded synthetic 64-frame
sequence runs.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.lifting import (
    engine,
    filtering,
    init3d,
    pose2d,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.device import (
    resolve_device,
)


def save(fname, lst):
    """The reference demo's txt dump (demo.py:15-23): per frame, each
    column of every array in turn, ``%e`` and a tab."""
    lst = [np.asarray(a) for a in lst]
    T, dim = lst[0].shape
    with open(fname, "w") as f:
        for t in range(T):
            for i in range(dim):
                for a in lst:
                    f.write("%e\t" % a[t, i])
            f.write("\n")


def load_sequence(path: str, key=None) -> np.ndarray:
    """A (T, 150) float32 sequence from an ``.npy`` file or an ``.h5`` file
    (``key``, or its first dataset)."""
    if path.endswith(".npy"):
        return np.asarray(np.load(path), dtype="float32")
    import h5py

    with h5py.File(path, "r") as f:
        key = key or list(f.keys())[0]
        return np.array(f.get(key), dtype="float32")


def synthetic_sequence() -> np.ndarray:
    """The root demo's fallback: 64 seeded OpenPose-like frames."""
    rng = np.random.RandomState(0)
    X = rng.uniform(100, 500, size=(64, 150)).astype("float32")
    X[:, 2::3] = rng.uniform(0.5, 1.0, size=(64, 50))
    return X


def main(args):
    """Run the demo; returns the filtered (x, y, z), each (T, 50) numpy."""
    dev = resolve_device(args.device)
    out_dir = args.out_dir
    os.makedirs(out_dir, exist_ok=True)
    if args.input and os.path.exists(args.input):
        X = load_sequence(args.input)
    else:
        print("no input sequence found; generating a synthetic sequence", flush=True)
        X = synthetic_sequence()
    if args.max_frames:
        X = X[: args.max_frames]
    print(f"sequence: {X.shape} on {dev}", flush=True)

    Xx, Xy, Xw = (torch.from_numpy(np.ascontiguousarray(X[:, k::3])).to(dev)
                  for k in range(3))
    Xx, Xy, _, _, _ = pose2d.normalization(Xx, Xy)
    save(os.path.join(out_dir, "demo1.txt"), [a.cpu() for a in (Xx, Xy, Xw)])

    Xx, Xy, Xw = pose2d.prune(Xx, Xy, Xw, (0, 1, 2, 3, 4, 5, 6, 7), 0.3)
    save(os.path.join(out_dir, "demo2.txt"), [a.cpu() for a in (Xx, Xy, Xw)])

    Xx, Xy, Xw = pose2d.interpolation(Xx, Xy, Xw, 0.99)
    save(os.path.join(out_dir, "demo3.txt"), [a.cpu() for a in (Xx, Xy, Xw)])

    noise = torch.from_numpy(engine._clip_noise(Xx.shape[0])).to(dev)[None]
    init = init3d.initialization(Xx[None], Xy[None], Xw[None], 0.001, noise=noise)
    lines0, rx0, ry0, rz0, ax0, ay0, az0, Yx0, Yy0, Yz0 = (a[0] for a in init)
    save(os.path.join(out_dir, "demo4.txt"), [a.cpu() for a in (Yx0, Yy0, Yz0)])

    Yx, Yy, Yz = filtering.backpropagation_based_filtering_v2(
        lines0, rx0, ry0, rz0, ax0, ay0, az0, Xx, Xy, Xw,
        learningRate=args.learning_rate, nCycles=args.n_cycles, device=dev,
    )
    out = [a.cpu().numpy() for a in (Yx, Yy, Yz)]
    save(os.path.join(out_dir, "demo5.txt"), out)
    print(f"wrote demo1..demo5 txt dumps to {out_dir}", flush=True)
    return tuple(out)


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--input", type=str, default="", help="input (T, 150) 2D sequence, .h5 (needs h5py) or .npy (default: the synthetic sequence)")
    parser.add_argument("--out_dir", type=str, default="demo_out", help="directory for demo txt dumps")
    parser.add_argument("--max_frames", type=int, default=0, help="truncate the sequence (0 = full)")
    parser.add_argument("--n_cycles", type=int, default=900, help="filtering SGD steps")
    parser.add_argument("--learning_rate", type=float, default=20.0, help="filtering SGD learning rate")
    parser.add_argument("--device", type=str, default="cuda", help="'cuda' or 'cpu'")
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
