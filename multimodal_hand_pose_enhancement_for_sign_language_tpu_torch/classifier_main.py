"""LSTM topic-classifier CLI of the port: the root ``classifier_main.py``.

    python -m multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.classifier_main \\
        --data_dir video_data [--data_type r6d] [--bidir True] [--device cpu]

The reference H2Sclassifier/Train_Test/main.py: r6d sequences -> 10-way
topic logits, cross-entropy on the last timestep, best-val-accuracy
checkpoint (``{exp}_checkpoint.pth`` under ``--models_dir``, reference
keys) and ``GT_predY.csv`` in the working directory.  Same flags as the
root CLI: weights from a generator seeded 1 and dropout masks from one
seeded 2 (hyperparameters.py:10), per-epoch reshuffle with
RandomState(23456) (main.py:75); remat is automatic unless ``--remat`` or
``--no_remat`` says otherwise; ``--epoch_scan`` keeps the dataset on the
device and sends only the permutation per epoch.  Runs on one CUDA device
(``--device cpu`` for the plain PyTorch path).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models.classifier import (
    build_classifier,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.train import (
    checkpoint as ckpt_lib,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.train.classifier import (
    ClassifierTrainer,
    dump_gt_pred_csv,
    load_data,
    should_remat,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.device import (
    resolve_device,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.metrics import (
    MetricsSink,
)

INIT_SEED = 1  # torch.manual_seed(1), hyperparameters.py:10
DROPOUT_SEED = 2


def run_epochs(args, trainer, X_train, Y_train, X_val, Y_val, sink, exp_name,
               epoch_scan=False):
    """The classifier CLIs' epoch loop: train, validate, log, keep the
    best-val-accuracy checkpoint and CSV, reshuffle.  Returns the best val
    accuracy."""
    shuffle_rng = np.random.RandomState(23456)  # main.py:75
    if epoch_scan:
        # device-resident path: the dataset is on the device once; only the
        # shuffle permutation crosses per epoch
        dX, dY = trainer.stage(X_train, Y_train)
        vX, vY = trainer.stage(X_val, Y_val)
        order = np.arange(X_train.shape[0])
    curr_best_acc = 0.0
    for epoch in range(args.num_epochs):
        if epoch_scan:
            tr_losses, tr_acc = trainer.train_epoch_resident(dX, dY, order, args.batch_size)
            val_loss, val_acc, (GT, predY) = trainer.val_epoch_resident(vX, vY, args.batch_size)
        else:
            tr_losses, tr_acc = trainer.train_epoch(X_train, Y_train, args.batch_size)
            val_loss, val_acc, (GT, predY) = trainer.val_epoch(X_val, Y_val, args.batch_size)
        sink.log({
            "epoch": epoch,
            "loss_train": float(np.mean(tr_losses)) if tr_losses else 0.0,
            "loss_val": val_loss,
            "acc_train": tr_acc,
            "acc_val": val_acc,
        })
        if epoch % args.log_step == 0:
            print(f"Epoch {epoch}: Tr. acc={tr_acc:.4f} Val. acc={val_acc:.4f} "
                  f"Val. loss={val_loss:.4f}", flush=True)
        if val_acc > curr_best_acc:
            curr_best_acc = val_acc
            ckpt_lib.save_checkpoint(
                os.path.join(args.models_dir, f"{exp_name}_checkpoint.pth"),
                trainer.checkpoint_payload(epoch))
            dump_gt_pred_csv(GT, predY)

        I = np.arange(X_train.shape[0])
        shuffle_rng.shuffle(I)
        if epoch_scan:
            order = order[I]  # compose permutations; data stays on the device
        else:
            X_train, Y_train = X_train[I], Y_train[I]
    sink.close()
    return curr_best_acc


def main(args):
    """Train; returns the best val accuracy."""
    device = resolve_device(args.device)
    exp_name = (
        f"{args.data_dir.split('/')[-1]}__{args.num_epochs}__{args.batch_size}"
        f"__{args.learning_rate}__{args.hidden_size}__{args.num_layers}"
        f"__bidir{args.bidir}__{args.weight_decay}__{args.dropout}__{args.optimizer}"
    )
    args.exp_name = exp_name
    sink = MetricsSink(exp_name, out_dir=args.models_dir, use_wandb=args.use_wandb)

    X_train, Y_train = load_data(args.data_dir, args.data_type, "train")
    X_val, Y_val = load_data(args.data_dir, args.data_type, "val")
    print(f"X_train {X_train.shape}, X_val {X_val.shape}", flush=True)

    if args.remat:
        remat = True
    elif args.no_remat:
        remat = False
    else:
        # auto: remat when the estimated activation footprint would not fit
        # the device; remat is exact, so this only trades recompute for memory
        remat = should_remat(args.batch_size, X_train.shape[1] if X_train.ndim == 3 else 192,
                             args.hidden_size, args.num_layers, args.bidir, device=device)
        if remat:
            print("===> auto-enabling LSTM remat (estimated activation footprint "
                  "exceeds device memory; pass --no_remat to override)", flush=True)

    module = build_classifier(
        "lstm", seed=INIT_SEED, device=device, input_size=X_train.shape[-1],
        hidden_size=args.hidden_size, num_layers=args.num_layers, num_classes=10,
        bidirectional=args.bidir, dropout=args.dropout, remat=remat)
    trainer = ClassifierTrainer(module, learning_rate=args.learning_rate,
                                weight_decay=args.weight_decay, optimizer=args.optimizer,
                                dropout_seed=DROPOUT_SEED)
    return run_epochs(args, trainer, X_train, Y_train, X_val, Y_val, sink, exp_name,
                      epoch_scan=args.epoch_scan)


def parse_bidir(value: str) -> bool:
    """The root CLI's reading of ``--bidir`` (classifier_main.py:186)."""
    return value in ("True", "T", "true")


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--data_dir', type=str, default="video_data", help='directory with r6d/categs pickles')
    parser.add_argument('--categs_dir', type=str, default="video_data", help='directory with category pickles')
    parser.add_argument('--data_type', type=str, default="r6d", help='"r6d", "grouped_r6d", "wordBert", ...')
    parser.add_argument('--models_dir', type=str, default="models/", help='checkpoint directory')
    parser.add_argument('--exp_name', type=str, default='experiment', help='experiment name')
    parser.add_argument('--num_epochs', type=int, default=200)
    parser.add_argument('--batch_size', type=int, default=128)
    parser.add_argument('--learning_rate', type=float, default=1e-4)
    parser.add_argument('--hidden_size', type=int, default=1024)
    parser.add_argument('--num_layers', type=int, default=10)
    parser.add_argument('--bidir', type=parse_bidir, default=False, help='"True", "T" or "true" for a bidirectional LSTM')
    parser.add_argument('--weight_decay', type=float, default=1e-3)
    parser.add_argument('--dropout', type=float, default=0.1)
    parser.add_argument('--optimizer', type=str, default="Adam", help='Adam | AdamW | NAdam')
    parser.add_argument('--remat', action="store_true",
                        help='force LSTM layer rematerialization in backward (exact). '
                             'Default is AUTO: remat is enabled when the estimated '
                             'activation footprint exceeds device memory')
    parser.add_argument('--no_remat', action="store_true", help='disable the automatic remat policy')
    parser.add_argument('--epoch_scan', action="store_true",
                        help='EXTENSION: stage the dataset in device memory once and feed '
                             'steps batch-index vectors only')
    parser.add_argument('--log_step', type=int, default=2)
    parser.add_argument('--use_wandb', action="store_true")
    parser.add_argument('--device', type=str, default="cuda", help="'cuda' or 'cpu'")
    return parser


if __name__ == "__main__":
    args = build_parser().parse_args()
    print(args, flush=True)
    main(args)
