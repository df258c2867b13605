"""MLP sentence-classifier CLI of the port: the root ``classifier_mlp_main.py``.

    python -m multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.classifier_mlp_main \\
        --data_dir video_data [--device cpu]

The reference H2Sclassifier/Train_Test/MLP_main.py: sentence embeddings
(``{split}_sentence_embeddings.pkl``) -> 10-way topic classification, with
the LSTM CLI's epoch loop, seeds, checkpoint and CSV
(``classifier_main.run_epochs``).  Runs on one CUDA device (``--device cpu``
for the plain PyTorch path).
"""

from __future__ import annotations

import argparse

import numpy as np

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.classifier_main import (
    INIT_SEED,
    run_epochs,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data.io import load_binary
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models.classifier import (
    build_classifier,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.train.classifier import (
    ClassifierTrainer,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.device import (
    resolve_device,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.metrics import (
    MetricsSink,
)


def load_mlp_data(data_dir: str, key: str):
    """Sentence embeddings + categories (MLP_main.py load_data)."""
    X = np.asarray(load_binary(f"{data_dir}/{key}_sentence_embeddings.pkl"), np.float32)
    Y = np.asarray(load_binary(f"{data_dir}/categs_{key}.pkl"))
    return X, Y


def main(args):
    """Train; returns the best val accuracy."""
    device = resolve_device(args.device)
    exp_name = (
        f"{args.data_dir.split('/')[-1]}__{args.num_epochs}__{args.batch_size}"
        f"__{args.learning_rate}__{args.weight_decay}__{args.optimizer}"
    )
    sink = MetricsSink(exp_name, out_dir=args.models_dir, use_wandb=args.use_wandb)

    X_train, Y_train = load_mlp_data(args.data_dir, "train")
    X_val, Y_val = load_mlp_data(args.data_dir, "val")
    print(f"X_train {X_train.shape}, X_val {X_val.shape}", flush=True)

    module = build_classifier("mlp", seed=INIT_SEED, device=device, in_dim=X_train.shape[-1])
    trainer = ClassifierTrainer(module, learning_rate=args.learning_rate,
                                weight_decay=args.weight_decay, optimizer=args.optimizer,
                                last_timestep_only=False)
    return run_epochs(args, trainer, X_train, Y_train, X_val, Y_val, sink, exp_name)


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--data_dir', type=str, default="video_data")
    parser.add_argument('--models_dir', type=str, default="models/")
    parser.add_argument('--num_epochs', type=int, default=200)
    parser.add_argument('--batch_size', type=int, default=128)
    parser.add_argument('--learning_rate', type=float, default=1e-4)
    parser.add_argument('--weight_decay', type=float, default=1e-3)
    parser.add_argument('--optimizer', type=str, default="Adam")
    parser.add_argument('--log_step', type=int, default=2)
    parser.add_argument('--use_wandb', action="store_true")
    parser.add_argument('--device', type=str, default="cuda", help="'cuda' or 'cpu'")
    return parser


if __name__ == "__main__":
    args = build_parser().parse_args()
    print(args, flush=True)
    main(args)
