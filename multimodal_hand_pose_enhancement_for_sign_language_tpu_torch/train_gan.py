"""GAN training CLI of the port: the root ``train_gan.py``.

    python -m multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.train_gan \\
        --data_dir video_data --loss RobustLoss --disc_label_smooth \\
        [--model {v1,v2,v4,v4_deeper} --require_text | --model b2h --require_image]

Same flags, same schedule (D every ``epochs_train_disc``-th epoch after
epoch 0, otherwise G then validation at half batch, early stop past epoch
100, best-val checkpointing, per-epoch reshuffle with RandomState(23456)),
same on-disk contracts (``{exp}{pipeline}_preprocess_core.npz``, best/last
checkpoints, here as ``.pth``), with the steps run eagerly on one CUDA
device (``--device cpu`` for the plain PyTorch path).  ``--epoch_scan``
keeps the dataset on the device and sends only the permutation per epoch.
``--bf16`` runs the models' compute in bfloat16 (weights, optimizer state
and losses float32); ``--log_grad_flow N`` logs the G loss's per-parameter
mean and max |gradient| every N epochs, on the first training batch.

``--prng_impl``, the JAX CLI's choice of dropout PRNG, has no counterpart
(dropout masks come from a ``torch.Generator``): it is accepted and raises
``NotImplementedError``; no flag is ignored.
"""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np
import torch

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.train import (
    checkpoint as ckpt_lib,
    data as data_lib,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.train.gan import (
    GanConfig,
    GanTrainer,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.train.schedulers import (
    ReduceLROnPlateau,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.constants import (
    FEATURE_MAP,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.metrics import (
    MetricsSink,
)

# flag -> (is it set?, why it is refused)
_NOT_PORTED = {
    "prng_impl": (lambda a: a.prng_impl is not None,
                  "no counterpart: dropout masks come from a torch.Generator"),
}


def _set_lr(optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def main(args, epoch_hook=None):
    """Train; returns the best validation loss.  ``epoch_hook(epoch, kind,
    trainer, losses)`` is called after every epoch (kind 'g' or 'd'; losses
    a dict of that epoch's averages)."""
    for flag, (is_set, item) in _NOT_PORTED.items():
        if is_set(args):
            raise NotImplementedError(f"--{flag} is not ported yet (ROADMAP {item})")
    if args.require_text and args.require_image:
        raise ValueError("--require_text and --require_image exclude each other")
    _, feature_out_dim = FEATURE_MAP[args.pipeline]
    rng = np.random.RandomState(23456)

    sink = MetricsSink(
        args.exp_name,
        out_dir=args.model_path,
        use_wandb=args.use_wandb,
        config=dict(
            epochs=args.num_epochs,
            batch_size=args.batch_size,
            learning_rate=args.learning_rate,
            model=args.model,
            pipeline=args.pipeline,
            epochs_train_disc=args.epochs_train_disc,
            disc_label_smooth=args.disc_label_smooth,
            data_dir=args.data_dir,
        ),
    )

    data = data_lib.load_data(
        args.data_dir, args.pipeline, args.model_path, args.exp_name, rng,
        require_text=args.require_text, require_image=args.require_image,
        embeds_type=args.embeds_type, base_path=args.base_path,
    )
    train_X, train_Y = data["train_X"], data["train_Y"]
    val_X, val_Y = data["val_X"], data["val_Y"]
    train_feats, val_feats = data["train_feats"], data["val_feats"]
    print(f"===> in/out train {train_X.shape} {train_Y.shape}", flush=True)
    print(f"===> in/out val   {val_X.shape} {val_Y.shape}", flush=True)

    cfg = GanConfig(
        model=args.model,
        pipeline=args.pipeline,
        feature_in_dim=train_X.shape[-1],
        feature_out_dim=feature_out_dim,
        batch_size=args.batch_size,
        learning_rate=args.learning_rate,
        num_epochs=args.num_epochs,
        patience=args.patience,
        epochs_train_disc=args.epochs_train_disc,
        disc_label_smooth=args.disc_label_smooth,
        loss=args.loss,
        require_text=args.require_text,
        require_image=args.require_image,
        effective_gan=args.effective_gan,
        default_size=args.default_size,
        window_t=train_X.shape[1],
        compute_dtype="bfloat16" if args.bf16 else "float32",
    )
    trainer = GanTrainer(cfg, device=args.device)
    if args.epoch_scan:
        # device-resident path: stage the dataset on the device once; only
        # the reference-exact shuffle permutation crosses per epoch
        trX, trY, trF = trainer.stage(train_X, train_Y, train_feats)
        vaX, vaY, vaF = trainer.stage(val_X, val_Y, val_feats)
        order = np.arange(len(train_X))
        val_order = np.arange(len(val_X))

        def run_epoch(X, Y, F, kind, batch_size):
            if kind == "val":
                return trainer.run_epoch_resident(vaX, vaY, val_order, kind,
                                                  batch_size, vaF)
            return trainer.run_epoch_resident(trX, trY, order, kind, batch_size, trF)

    else:
        def run_epoch(X, Y, F, kind, batch_size):
            return trainer.run_epoch(X, Y, kind, batch_size, F)

    last_checkpoint = None
    if args.use_checkpoint:
        loaded = ckpt_lib.load_checkpoint(
            os.path.join(args.model_path, f"lastCheckpoint_{args.exp_name}.pth"),
            map_location=trainer.device,
        )
        trainer.load_checkpoint_payload(loaded)
        print(f"===> resumed from epoch {loaded['epoch']}", flush=True)

    g_sched = ReduceLROnPlateau(args.learning_rate)
    d_sched = ReduceLROnPlateau(args.learning_rate)

    curr_best = 1e9
    prev_save_epoch = 0
    last_grad_flow_epoch = -(10**9)
    for epoch in range(args.num_epochs):
        if epoch > 100 and (epoch - prev_save_epoch) > args.patience:
            print(f"early stopping at: {epoch - 1}", flush=True)
            break
        if epoch > 0 and (
            args.epochs_train_disc == 0 or epoch % args.epochs_train_disc == 0
        ):
            d_loss = run_epoch(train_X, train_Y, train_feats, "d", args.batch_size)
            print(
                f"Epoch [{epoch}/{args.num_epochs-1}], Tr. Disc. Loss: {d_loss}",
                flush=True,
            )
            sink.log({"epoch": epoch, "loss_train_disc": d_loss})
            if epoch_hook is not None:
                epoch_hook(epoch, "d", trainer, {"loss_train_disc": d_loss})
        else:
            g_loss = run_epoch(train_X, train_Y, train_feats, "g", args.batch_size)
            print(
                f"Epoch [{epoch}/{args.num_epochs-1}], Tr. Loss: {g_loss:.4f}, "
                f"Tr. Perplexity: {np.exp(min(g_loss, 700)):5.4f}",
                flush=True,
            )
            sink.log({"epoch": epoch, "loss_train_gen": g_loss})

            val_loss = run_epoch(val_X, val_Y, val_feats, "val",
                                 max(args.batch_size // 2, 1))
            print(
                f"Epoch [{epoch}/{args.num_epochs-1}], Val. Loss: {val_loss:.4f}",
                flush=True,
            )
            sink.log({"loss_val_gen": val_loss})
            _set_lr(trainer.g_opt, g_sched.step(val_loss))
            _set_lr(trainer.d_opt, d_sched.step(val_loss))

            if val_loss < curr_best:
                prev_save_epoch = epoch
                curr_best = val_loss
                fname = os.path.join(
                    args.model_path, f"{args.exp_name}_checkpoint.pth"
                )
                payload = trainer.checkpoint_payload(epoch)
                payload["config"] = {
                    k: v for k, v in vars(args).items()
                    if isinstance(v, (bool, int, float, str, type(None)))
                }
                ckpt_lib.save_checkpoint(fname, payload)
                last_checkpoint = fname
                ckpt_lib.save_checkpoint(
                    os.path.join(
                        args.model_path, f"discriminator_{args.exp_name}.pth"
                    ),
                    {
                        "epoch": epoch,
                        "state_dict": payload["discriminator"],
                        "d_optimizer": payload["d_optimizer"],
                    },
                )
            if epoch_hook is not None:
                epoch_hook(epoch, "g", trainer,
                           {"loss_train_gen": g_loss, "loss_val_gen": val_loss})

        if args.log_grad_flow and (epoch - last_grad_flow_epoch) >= args.log_grad_flow:
            last_grad_flow_epoch = epoch
            bs = min(args.batch_size, len(train_X))
            x, y, f = (None if a is None else
                       torch.from_numpy(np.ascontiguousarray(a[:bs])).to(trainer.device)
                       for a in (train_X, train_Y, train_feats))
            stats = trainer.grad_flow(x, y, f)
            worst = max(stats.values(), key=lambda s: s["max"])
            sink.log({"epoch": epoch, "event": "grad_flow",
                      **{k: v["ave"] for k, v in stats.items()}})
            print(f"grad-flow: max |g| {worst['max']:.3e}", flush=True)

        # per-epoch reshuffle (reference train_gan.py:113-119)
        I = np.arange(len(train_X))
        rng.shuffle(I)
        if args.epoch_scan:
            order = order[I]  # compose permutations; data stays on the device
        else:
            train_X, train_Y = train_X[I], train_Y[I]
            if train_feats is not None:
                train_feats = train_feats[I]

    if last_checkpoint:
        shutil.copyfile(
            last_checkpoint,
            os.path.join(args.model_path, f"lastCheckpoint_{args.exp_name}.pth"),
        )
    sink.close()
    return curr_best


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--base_path', type=str, default="./", help='path to the directory where the data files are stored')
    parser.add_argument('--pipeline', type=str, default='arm2wh', help='pipeline specifying which input/output joints to use')
    parser.add_argument('--num_epochs', type=int, default=200, help='number of training epochs')
    parser.add_argument('--batch_size', type=int, default=128, help='batch size for training')
    parser.add_argument('--learning_rate', type=float, default=1e-4, help='learning rate for training G and D')
    parser.add_argument('--require_text', action="store_true", help="condition the generator on the clips' sentence embeddings")
    parser.add_argument('--require_image', action="store_true", help="condition the generator on per-frame image features (b2h)")
    parser.add_argument('--embeds_type', type=str, default="normal", help='if "normal", use normal text embeds; if "average", use avg text embeds')
    parser.add_argument('--model_path', type=str, default="models/", help='path for saving trained models')
    parser.add_argument('--log_step', type=int, default=25, help='step size for printing log info')
    parser.add_argument('--tag', type=str, default='', help='prefix for naming purposes')
    parser.add_argument('--exp_name', type=str, default='experiment', help='name for the experiment')
    parser.add_argument('--patience', type=int, default=100, help='amount of epochs without loss improvement before termination')
    parser.add_argument('--use_checkpoint', action="store_true", help="use checkpoint from which to start training")
    parser.add_argument('--prng_impl', type=str, default=None, choices=["rbg", "threefry2x32"], help="the JAX CLI's dropout PRNG choice; has no counterpart here and raises when given")
    parser.add_argument('--epochs_train_disc', type=int, default=3, help='train the discriminator every epochs_train_disc epochs')
    parser.add_argument('--model', type=str, default="v1", help='model architecture: v1, b2h, v2, v4 or v4_deeper')
    parser.add_argument('--disc_label_smooth', action="store_true", help="if True, use label smoothing for the discriminator")
    parser.add_argument('--data_dir', type=str, default="video_data", help='directory where results should be stored and loaded from')
    parser.add_argument('--loss', type=str, default="L1", help='Loss to optimize the generator over')
    parser.add_argument('--use_wandb', action="store_true", help="log to wandb in addition to local JSONL")
    parser.add_argument('--effective_gan', action="store_true", help="EXTENSION: give the adversarial term a real gradient (the reference detaches it)")
    parser.add_argument('--bf16', action="store_true", help="EXTENSION: run model compute in bfloat16 (params/optimizer stay f32)")
    parser.add_argument('--log_grad_flow', type=int, default=0, help='log per-layer gradient stats every N epochs (0 = off); the wandb.watch analog')
    parser.add_argument('--default_size', type=int, default=256, help='generator embed width (reference default 256)')
    parser.add_argument('--epoch_scan', action="store_true", help="EXTENSION: keep the dataset resident in device memory; only the permutation crosses per epoch")
    parser.add_argument('--device', type=str, default="cuda", help="'cuda' or 'cpu'")
    return parser


if __name__ == "__main__":
    args = build_parser().parse_args()
    print(args, flush=True)
    main(args)
