"""Dataset construction CLI of the port: OpenPose JSON tree -> pickles.

    python -m multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.process_dataset \\
        --dataset_path RAW --data_dir video_data --lift [--device cpu]

The counterpart of the root ``process_dataset.py`` (the reference's
process_H2S_dataset path, utils/utils.py:430-571), with the same flags
plus ``--device``.  For each split it reads the utterance directories of
the OpenPose tree that have text, groups them into videos (the default;
``--no-group_by_clip`` keeps utterances), and writes into ``--data_dir``
``xy_{split}.pkl`` (neck, arms and hands with their confidences), the
reference's ``{group_key}_confTrue_xy_{split}.pkl`` name for it (a hard
link, or a copy), and ``categs_{split}.pkl``.  With ``--lift`` it lifts
``xy`` through the port's ``lift.lift_split`` (the partitioned
``lift_2d_to_3d``, the ``filter_sgd`` kernel on the card) into
``xyz_{split}.pkl`` and ``r6d_{split}.pkl``, and for the train split
``lengths_train.pkl``.

A model ``--text_method`` (BERTsentence, BERTword, clip) writes
``{split}_sentence_embeddings.pkl`` and its ``average_`` form through
``data/text.obtain_embeddings``; the CLI passes no snapshot, as the root
one, so that is the hub route.  ``--crops`` writes ``{split}_vid_crops.pkl``
from the split's videos (``--vid_template``; cv2), and ``--vid_feats``
writes ``{split}_vid_feats.pkl`` ((T, 2000) per clip, the ResNet-50 of
``--resnet_weights`` on ``--device``) from the videos; for a split without
a video directory whose crops pickle is already in ``--data_dir`` (written
by ``--crops``, perhaps on a machine with cv2), ``--vid_feats`` featurizes
those crops.  This module imports no torch until a device stage runs, so
that the ingestion's spawn workers start fast.
"""

from __future__ import annotations

import argparse
import os
import shutil
import time

import numpy as np

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data import (
    categories as categ_lib,
    openpose,
    text as text_lib,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data.io import (
    mkdir,
    save_binary,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.constants import (
    ARMS,
    DATA_PATHS,
    HANDS,
    NECK,
)


def process_split(args, split: str, pool=None):
    """One split's pickles, its utterances read in ``pool`` (or a pool of
    its own); returns its counts and the wall time of each stage (None for
    a split without a json directory)."""
    json_dir = os.path.join(args.dataset_path, DATA_PATHS[split])
    if not os.path.isdir(json_dir):
        print(f"[{split}] no json dir at {json_dir}; skipping", flush=True)
        return None
    ids = sorted(os.listdir(json_dir))

    # intersect with the ids that have text
    text_path = args.text_path_template.format(split=split)
    if os.path.exists(text_path):
        ids = sorted(set(ids) & set(text_lib.get_clip_ids(text_path)))
    print(f"[{split}] {len(ids)} utterances", flush=True)
    if args.subset < 1.0:
        ids = ids[: int(len(ids) * args.subset)]

    t0 = time.perf_counter()
    clips, in_feats, out_feats = openpose.load_utterances_parallel(
        ids, json_dir, max_workers=args.workers, pool=pool
    )
    stats = {"utterances": len(ids), "frames": sum(len(f) for f in in_feats),
             "ingest_s": time.perf_counter() - t0}
    if args.group_by_clip:
        clips, in_feats, out_feats = openpose.group_clips(clips, in_feats, out_feats)

    neck = openpose.select_keypoints(in_feats, NECK)
    arms = openpose.select_keypoints(in_feats, ARMS)
    hands = openpose.select_keypoints(out_feats, HANDS)
    feats = openpose.hconcat_feats(neck, arms, hands)
    xy_path = os.path.join(args.data_dir, f"xy_{split}.pkl")
    save_binary(feats, xy_path)
    # the reference's file name (utils/utils.py:431-434, 464-466):
    # {groupByKey}_conf{keep_confidence}_xy_{split}.pkl, groupByKey "True"
    # when grouping and "" otherwise; a hard link saves a second write
    group_key = "True" if args.group_by_clip else ""
    ref_path = os.path.join(args.data_dir, f"{group_key}_confTrue_xy_{split}.pkl")
    if os.path.exists(ref_path):
        os.unlink(ref_path)
    try:
        os.link(xy_path, ref_path)
    except OSError:
        shutil.copyfile(xy_path, ref_path)
    stats["clips"] = len(feats)
    print(f"[{split}] wrote {xy_path} (+ {os.path.basename(ref_path)}): "
          f"{stats['frames']} frames ingested in {stats['ingest_s']:.3f} s", flush=True)

    # text embeddings: "precomputed" writes none (data/text.py)
    if os.path.exists(text_path):
        embeds = text_lib.obtain_embeddings(
            text_path, ids, method=args.text_method, groupByClip=args.group_by_clip,
            device=args.device,
        )
        if embeds is not None:
            save_binary(np.asarray(embeds),
                        os.path.join(args.data_dir, f"{split}_sentence_embeddings.pkl"))
            save_binary(text_lib.average_embeds(embeds),
                        os.path.join(args.data_dir,
                                     f"average_{split}_sentence_embeddings.pkl"))

    categ_path = args.categ_path_template.format(split=split)
    if os.path.exists(categ_path):
        id_categ = categ_lib.get_ids_categ(categ_path)
        if args.group_by_clip:
            categs = [v for _, v in sorted(id_categ.items())]
        else:
            categs = categ_lib.get_clips_categ(clips, id_categ)
        save_binary(categs, os.path.join(args.data_dir, f"categs_{split}.pkl"))

    if args.crops or args.vid_feats:
        video_stage(args, split)

    if args.lift:
        from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch import lift

        t0 = time.perf_counter()
        lift.lift_split(args.data_dir, split, n_partitions=args.n_partitions,
                        n_cycles=args.n_cycles, device=args.device)
        stats["lift_s"] = time.perf_counter() - t0
        print(f"[{split}] lifted and converted in {stats['lift_s']:.3f} s", flush=True)
    return stats


def video_stage(args, split: str) -> None:
    """Hand crops or their ResNet-50 features for one split (the reference's
    commented-out b2h continuation, utils/utils.py:536-554)."""
    from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data import (
        datasets as datasets_lib,
    )

    paths = datasets_lib.DatasetPaths(
        args.dataset_path, text_template=args.text_path_template,
        categ_template=args.categ_path_template, vid_template=args.vid_template)
    crops_path = os.path.join(args.data_dir, f"{split}_vid_crops.pkl")
    if os.path.isdir(paths.vid_dir(split)):
        if args.vid_feats:
            datasets_lib.obtain_vid_crops_and_feats(
                paths, split, args.data_dir, weights_path=args.resnet_weights,
                chunk=args.vid_chunk, device=args.device)
            print(f"[{split}] wrote {split}_vid_feats.pkl", flush=True)
        else:
            datasets_lib.obtain_vid_crops(paths, split, args.data_dir, chunk=args.vid_chunk)
            print(f"[{split}] wrote {split}_vid_crops.pkl", flush=True)
    elif args.vid_feats and os.path.exists(crops_path):
        datasets_lib.obtain_vid_feats(split, args.data_dir, weights_path=args.resnet_weights,
                                      device=args.device)
        print(f"[{split}] wrote {split}_vid_feats.pkl from {split}_vid_crops.pkl", flush=True)
    else:
        print(f"[{split}] no videos at {paths.vid_dir(split)}; skipping crops", flush=True)


def resolve_templates(args):
    """The root CLI's rule: a relative text template that does not exist as
    given is taken relative to the dataset root, and the category template
    with it (process_dataset.py:212-224)."""
    if not os.path.isabs(args.text_path_template) and not os.path.exists(
        args.text_path_template.format(split="train")
    ):
        args.text_path_template = os.path.join(args.dataset_path, args.text_path_template)
        args.categ_path_template = os.path.join(args.dataset_path, args.categ_path_template)
    return args


def main(args) -> dict:
    """Every split's pickles; returns {split: process_split's stats}."""
    if args.lift or args.vid_feats or args.text_method != "precomputed":
        from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.device import (
            resolve_device,
        )

        resolve_device(args.device)  # fail before the ingestion, not after it
    mkdir(args.data_dir)
    # one worker pool for the three splits: its workers start once
    with openpose.worker_pool(args.workers) as pool:
        return {split: process_split(args, split, pool) for split in ("test", "val", "train")}


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dataset_path", type=str, required=True, help="root of the OpenPose-format dataset")
    parser.add_argument("--data_dir", type=str, default="video_data", help="output directory")
    parser.add_argument("--text_path_template", type=str, default="{split}.text.id.en", help="per-split text id file (relative or absolute; {split} substituted)")
    parser.add_argument("--categ_path_template", type=str, default="videoID_categoryID_{split}.csv", help="per-split category csv")
    parser.add_argument("--text_method", type=str, default="precomputed", help="text embedding method (precomputed|BERTsentence|clip|BERTword)")
    parser.add_argument("--subset", type=float, default=1.0, help="fraction of utterances to keep")
    parser.add_argument("--group_by_clip", action=argparse.BooleanOptionalAction, default=True, help="group utterances into videos (reference default); --no-group_by_clip for utterance-level")
    parser.add_argument("--lift", action="store_true", help="run 2D->3D lifting + r6d conversion")
    parser.add_argument("--crops", action="store_true", help="extract 120x120 hand crops from videos (reference utils/utils.py:536-545)")
    parser.add_argument("--vid_feats", action="store_true", help="extract crops AND ResNet-50 hand features (reference utils/utils.py:547-554)")
    parser.add_argument("--vid_template", type=str, default="{split}/rgb_front/raw_videos", help="per-split video directory (relative to dataset root or absolute)")
    parser.add_argument("--resnet_weights", type=str, default=None, help="torchvision resnet50 .pth for the hand features")
    parser.add_argument("--vid_chunk", type=int, default=500, help="clips per persisted crops/feats chunk")
    parser.add_argument("--n_partitions", type=int, default=40, help="lifting checkpoint partitions")
    parser.add_argument("--n_cycles", type=int, default=900, help="lifting SGD cycles")
    parser.add_argument("--workers", type=int, default=None, help="ingestion processes")
    parser.add_argument("--device", type=str, default="cuda", help="'cuda' or 'cpu' for the lifting, the features and the text towers")
    return parser


if __name__ == "__main__":
    main(resolve_templates(build_parser().parse_args()))
