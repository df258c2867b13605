"""Inference CLI of the port: the root ``inference.py``.

    python -m multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.inference \\
        --checkpoint models/experiment_checkpoint.pkl --data_dir video_data \\
        [--model {v1,v2,v4,v4_deeper} --require_text | --model b2h --require_image]

Loads r6d windows (with the split's sentence embeddings under
``--require_text``, its per-frame ResNet features ``{set}_vid_feats.pkl``
under ``--require_image``), standardizes them with the checkpoint's
train-time statistics, runs the generator's eval forward (on CUDA unless
``--device cpu``), de-standardizes and writes the r6d/aa/xyz result
pickles.  The checkpoint is a reference ``.pth`` or a JAX-package ``.pkl``.
``--bf16`` runs the forward in bfloat16 (outputs back in float32), as the
root CLI's.  Rendering GIFs and the root CLI's ``--matmul_precision
bfloat16`` (XLA's one-pass bfloat16 product of float32 operands) are not
ported.  Launched by ``python -m torch.distributed.run``, every rank loads
the windows, the batches are sharded over a mesh of all ranks
(``run_inference(mesh=...)``, NCCL on ``cuda:LOCAL_RANK``, gloo with
``--device cpu``) and rank 0 alone prints and writes the results.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch import infer as infer_lib
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data import (
    standardize as std_lib,
    windows as win_lib,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data.io import save_binary
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models import registry
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.parallel import (
    multihost,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.train.checkpoint import (
    load_generator_state,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.constants import (
    FEATURE_MAP,
)


def main(args):
    """Enhance the split; returns the mean L1 error (every rank)."""
    if args.require_text and args.require_image:
        raise ValueError("--require_text and --require_image exclude each other")
    mesh, device = multihost.start(args.device)
    with multihost.main_output_only(mesh):
        return _infer(args, mesh, device)


def _infer(args, mesh, device):
    pipeline = args.pipeline
    _, feature_out_dim = FEATURE_MAP[pipeline]
    r6d_path = f"{args.data_dir}/r6d_{args.infer_set}.pkl"
    if args.embeds_type == "normal":
        text_path = f"{args.data_dir}/{args.infer_set}_sentence_embeddings.pkl"
    else:
        text_path = f"{args.data_dir}/average_{args.infer_set}_sentence_embeddings.pkl"
    image_path = f"{args.data_dir}/{args.infer_set}_vid_feats.pkl"
    loaded = win_lib.load_windows(
        r6d_path, pipeline, require_text=args.require_text, text_path=text_path,
        require_image=args.require_image, image_path=image_path,
        num_samples=args.num_samples, return_indices=True,
    )
    if loaded is None:
        raise FileNotFoundError(r6d_path)
    test_X, test_Y, orig_idx = loaded
    test_feats = None
    if args.require_text or args.require_image:
        test_X, test_feats = test_X
    dropped = win_lib.nan_clip_indices(test_X, test_Y, test_feats)
    orig_idx = np.delete(np.asarray(orig_idx, dtype=int), dropped)
    test_X, test_Y, test_feats = win_lib.rmv_clips_nan(
        test_X, test_Y, test_feats, idx_nan=dropped
    )
    print(f"test_X.shape, test_Y.shape: {test_X.shape}, {test_Y.shape}", flush=True)
    input_feats = test_X.copy()  # (N, T, D) r6d at the original scale
    if pipeline == "wh2wh":
        test_X = test_X[:, :, 6 * 6 :]

    # standardize with the train-time statistics (checkpoint contract)
    checkpoint_dir = os.path.split(args.checkpoint)[0]
    mean_X, std_X, mean_Y, std_Y = std_lib.load_standardization(
        os.path.join(checkpoint_dir, f"{args.exp_name}{pipeline}_preprocess_core.npz")
    )
    # stats are (1, D, 1); windows are (N, T, D)
    mX, sX = mean_X.transpose(0, 2, 1), std_X.transpose(0, 2, 1)
    mY, sY = mean_Y.transpose(0, 2, 1), std_Y.transpose(0, 2, 1)
    test_X = ((test_X - mX) / sX).astype(np.float32)
    test_Y = ((test_Y - mY) / sY).astype(np.float32)

    model = registry.build_generator(
        args.model, test_X.shape[-1], feature_out_dim,
        require_text=args.require_text, require_image=args.require_image,
        default_size=args.default_size, device=device,
    )
    model.load_state_dict(load_generator_state(args.checkpoint), strict=True)
    output, error = infer_lib.run_inference(
        model, test_X, test_feats=test_feats, batch_size=args.batch_size,
        num_samples=args.num_samples, test_Y=test_Y,
        matmul_precision=args.matmul_precision, device=device, bf16=args.bf16, mesh=mesh,
    )
    print(">>> TOTAL ERROR: ", error, flush=True)
    if mesh is not None and mesh.rank != 0:
        return error

    output = (output * sY + mY).astype(np.float32)
    xyz_path = infer_lib.save_results(
        input_feats[: output.shape[0]], output, pipeline, args.base_path,
        data_dir=args.data_dir, tag=args.exp_name, infer_set=args.infer_set,
        device=device,
    )
    # row j of the result pickles comes from clip orig_idx[j] of the split
    if xyz_path:
        save_binary(
            [int(i) for i in orig_idx[: output.shape[0]]],
            os.path.join(os.path.dirname(xyz_path), f"sel_indices_{args.infer_set}.pkl"),
        )
    print("Saved results.", flush=True)
    return error


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", type=str, default="models/lastCheckpoint.pkl", help="checkpoint: JAX-package .pkl or reference .pth")
    p.add_argument("--base_path", type=str, default="./", help="base directory of the results")
    p.add_argument("--data_dir", type=str, default="video_data", help="directory of the r6d/xyz pickles")
    p.add_argument("--pipeline", type=str, default="arm2wh", help="input/output joint pipeline")
    p.add_argument("--require_text", action="store_true", help="use text embeddings as input")
    p.add_argument("--require_image", action="store_true", help="use per-frame image features as input (b2h)")
    p.add_argument("--embeds_type", type=str, default="normal", help='"normal" or "average" text embeds')
    p.add_argument("--infer_set", type=str, default="test", help="split to run on")
    p.add_argument("--batch_size", type=int, default=128, help="inference batch size")
    p.add_argument("--exp_name", type=str, default="experiment", help="experiment name")
    p.add_argument("--model", type=str, default="v1", help="model architecture: v1, b2h, v2, v4 or v4_deeper")
    p.add_argument("--default_size", type=int, default=256, help="generator embed width the checkpoint was trained with")
    p.add_argument("--num_samples", type=int, default=3000, help="number of sequences to predict")
    p.add_argument("--bf16", action="store_true", help="EXTENSION: run the forward in bfloat16")
    p.add_argument("--matmul_precision", type=str, default="float32", help="'float32' (TF32 off) or 'tensorfloat32'")
    p.add_argument("--device", type=str, default="cuda", help="'cuda' or 'cpu'")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
    multihost.finish()
