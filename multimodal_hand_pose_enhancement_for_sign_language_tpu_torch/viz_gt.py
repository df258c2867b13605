"""Ground-truth visualization CLI of the port: the root ``viz_gt.py``.

    python -m multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.viz_gt \\
        [--file_path XYZ.pkl] [--data_dir video_data] [--seqs_to_viz 20] [--device cpu]

With ``--file_path`` an existing xyz pickle: its first ``--seqs_to_viz``
clips to GIFs in ``--results_dir``.  Otherwise the reference's viz_GT
(viz/viz_3d.py:80-116): the r6d windows of ``--infer_set``, the clips
holding NaN dropped from the first ``seqs_to_viz + 10``, the first
``seqs_to_viz`` through ``infer.save_results`` on ``--device`` (CUDA
unless ``--device cpu``; r6d -> aa -> xyz pickles under
``results_{exp_name}_{infer_set}``), then their xyz to GIFs in
``viz_results_{exp_name}_{infer_set}``, or in ``--results_dir`` when it is
given.  GIFs need matplotlib and PIL: without them the CLI refuses before
any work.
"""

from __future__ import annotations

import argparse
import os

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch import infer as infer_lib
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data import (
    windows as win_lib,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data.io import load_binary
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.device import (
    resolve_device,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.viz import viz_3d


def main(args):
    """Render; returns the GIF paths."""
    if args.seqs_to_viz > 0:
        viz_3d.require()  # refuse before any work
    # direct mode: an existing xyz pickle (reference --file_path)
    if args.file_path and os.path.exists(args.file_path):
        xyz = load_binary(args.file_path)[: args.seqs_to_viz]
        gifs = viz_3d.viz(xyz, frame_rate=2, results_dir=args.results_dir)
        print(f"rendered {len(gifs)} GIFs from {args.file_path}", flush=True)
        return gifs

    device = resolve_device(args.device)
    r6d_path = f"{args.data_dir}/r6d_{args.infer_set}.pkl"
    loaded = win_lib.load_windows(r6d_path, args.pipeline)
    if loaded is None:
        raise FileNotFoundError(r6d_path)
    X, Y = loaded
    X, Y, _ = win_lib.rmv_clips_nan(X[: args.seqs_to_viz + 10], Y[: args.seqs_to_viz + 10])
    xyz_path = infer_lib.save_results(
        X[: args.seqs_to_viz], Y[: args.seqs_to_viz], args.pipeline, args.base_path,
        data_dir=args.data_dir, tag=f"{args.exp_name}_{args.infer_set}",
        infer_set=args.infer_set, device=device,
    )
    xyz = load_binary(xyz_path)[: args.seqs_to_viz]
    results_dir = (args.results_dir if args.results_dir != "viz_results"
                   else f"viz_results_{args.exp_name}_{args.infer_set}")
    gifs = viz_3d.viz(xyz, frame_rate=2, results_dir=results_dir)
    print(f"rendered {len(gifs)} GIFs", flush=True)
    return gifs


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--base_path", type=str, default="./")
    p.add_argument("--file_path", type=str, default="", help="existing xyz pickle to visualize directly (skips save_results)")
    p.add_argument("--seqs_to_viz", type=int, default=20)
    p.add_argument("--pipeline", type=str, default="arm2wh")
    p.add_argument("--results_dir", type=str, default="viz_results")
    p.add_argument("--data_dir", type=str, default="video_data")
    p.add_argument("--infer_set", type=str, default="test")
    p.add_argument("--exp_name", type=str, default="experiment")
    p.add_argument("--device", type=str, default="cuda", help="'cuda' or 'cpu' (save_results' geometry)")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
