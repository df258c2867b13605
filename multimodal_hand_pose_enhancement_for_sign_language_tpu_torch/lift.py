"""Lifting CLI of the port: the ``process_dataset.py --lift`` stage.

    python -m multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.lift \\
        --data_dir video_data

For each split, reads the 2D keypoint clips ``{data_dir}/xy_{split}.pkl``
(written by the ingestion of the port's ``process_dataset``, which runs
this stage itself with ``--lift``), lifts them to 3D with the
partitioned, resumable ``lift_2d_to_3d`` into ``xyz_{split}.pkl``, then
converts xyz -> axis-angle -> r6d into ``r6d_{split}.pkl`` (and, for the
train split, the mean bone lengths into ``lengths_train.pkl``).  With a
``mesh`` the lifting is spread over its ranks and rank 0 writes.
"""

from __future__ import annotations

import argparse
import os

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data.io import (
    load_binary,
    save_binary,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.lifting import (
    engine as lift_engine,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops import (
    kinematics,
    rotations,
)


def lift_split(data_dir, split, n_partitions=40, n_cycles=900, device="cuda", mesh=None):
    """Lift one split and convert it; returns its r6d clips (on rank 0
    under a mesh, None on the others, which write nothing)."""
    feats = load_binary(os.path.join(data_dir, f"xy_{split}.pkl"))
    xyz_path = os.path.join(data_dir, f"xyz_{split}.pkl")
    xyz = lift_engine.lift_2d_to_3d(
        feats, xyz_path, nPartitions=n_partitions, n_cycles=n_cycles, device=device,
        mesh=mesh,
    )
    if mesh is not None and mesh.rank != 0:
        return None
    print(f"[{split}] lifted -> {xyz_path}", flush=True)
    if split == "train":
        save_binary(kinematics.get_bone_length(xyz),
                    os.path.join(data_dir, "lengths_train.pkl"))
    aa = kinematics.xyz_to_aa(xyz, device=device)
    r6d = rotations.aa_to_rot6d(aa, device=device)
    save_binary(r6d, os.path.join(data_dir, f"r6d_{split}.pkl"))
    print(f"[{split}] wrote r6d", flush=True)
    return r6d


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data_dir", type=str, default="video_data", help="directory of xy_{split}.pkl and the outputs")
    p.add_argument("--splits", nargs="+", default=["test", "val", "train"], help="splits to lift")
    p.add_argument("--n_partitions", type=int, default=40, help="lifting checkpoint partitions")
    p.add_argument("--n_cycles", type=int, default=900, help="lifting SGD cycles")
    p.add_argument("--device", type=str, default="cuda", help="'cuda' or 'cpu'")
    return p


if __name__ == "__main__":
    args = build_parser().parse_args()
    for split in args.splits:
        lift_split(args.data_dir, split, args.n_partitions, args.n_cycles, args.device)
