"""Training loops for the downstream classifiers.

PyTorch counterpart of the JAX package's ``train/classifier.py``, the
re-design of H2Sclassifier/Train_Test (train_epoch.py:8-33,
val_epoch.py:7-36, main.py:23-140, MLP_main.py): eager train and eval
steps, cross-entropy on the LAST timestep's logits (labels are 1-based on
disk and shifted by -1), accuracy accounting, the device-resident epoch
loops and the GT/pred CSV dump.

The trainer holds its state in the module and the optimizer.  Every step
runs at float32: TF32 off for cuDNN, whose RNNs would otherwise multiply in
TF32, and for cuBLAS; both switches restored afterwards.  Inter-layer
dropout draws from the trainer's own ``torch.Generator`` on the module's
device.

With the tracer on (``utils/profiling``) each train step is the span
``classif.train_step``, holding ``classif.forward`` (the logits and the
loss), ``classif.backward`` (``loss.backward``) and ``classif.optim``
(``zero_grad``; the reduction over 'data' and ``opt.step``); each eval step
is ``classif.eval_step``, and each batch's copy in ``classif.h2d``.  The
counter ``classif.frames`` adds the rows times the timesteps of every train
or eval step.

With a ``mesh`` (``parallel/mesh.get_mesh``) the train step is the JAX
trainer's data-parallel one (tests/test_multichip.py): the weights are
broadcast at start, each rank computes its rows of the global batch (its
dropout masks cut from the global batch's), and the gradients, the loss and
the correct count go into one bucket, summed over 'data': the gradients and
the loss are then divided into global means, the count stays a global sum.
A batch whose rows do not divide 'data' runs whole on every rank.  The
eval step runs the whole batch on every rank.
"""

from __future__ import annotations

import csv
from itertools import zip_longest

import numpy as np
import torch
import torch.distributed as dist
from torch.nn import functional as F

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data.io import load_binary
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data.windows import (
    make_equal_len,
    rmv_clips_nan,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.infer import (
    conv_matmul_precision,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models.layers import (
    set_dropout_generator,
    set_dropout_rows,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.parallel import (
    mesh as mesh_lib,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.train.optim import (
    make_optimizer,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.train.staging import (
    Staged,
    flatten_rows,
    unflatten_batch,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.device import (
    resolve_device,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.profiling import (
    count,
    span,
)


def lstm_activation_bytes(batch_size: int, seq_len: int, hidden_size: int,
                          num_layers: int, bidirectional: bool,
                          dtype_bytes: int = 4) -> int:
    """Saved-activation footprint of one ClassifLSTM backward pass without
    remat, the JAX package's estimate: per layer, direction and step the
    gates (4H), cell state, hidden and output (H each) and the layer's input
    (dirs * H + 1), times a 1.5 calibration factor.  The JAX package anchored
    that factor to ~27 GB measured on a TPU for hidden 1024, 10 layers,
    bidirectional, B=128, T=192; ``chip_smoke.py`` prints the port's own
    peak memory beside it."""
    dirs = 2 if bidirectional else 1
    per_step = 7 * hidden_size + (dirs * hidden_size + 1)
    return int(1.5 * batch_size * seq_len * num_layers * dirs * per_step * dtype_bytes)


def should_remat(batch_size: int, seq_len: int, hidden_size: int, num_layers: int,
                 bidirectional: bool, device="cuda", memory_limit_bytes=None,
                 headroom: float = 0.8) -> bool:
    """The CLI's automatic remat policy: rematerialise the LSTM layers when
    the estimated activation footprint exceeds ``headroom`` times the
    device's memory (the card's total memory; ``memory_limit_bytes``
    overrides it).  On the CPU the answer is False, as the JAX package's is
    off the TPU."""
    if memory_limit_bytes is None:
        dev = resolve_device(device)
        if dev.type != "cuda":
            return False
        memory_limit_bytes = torch.cuda.get_device_properties(dev).total_memory
    need = lstm_activation_bytes(batch_size, seq_len, hidden_size, num_layers,
                                 bidirectional)
    return need > headroom * memory_limit_bytes


def load_data(data_dir: str, data_type: str = "r6d", key: str = "train"):
    """Reference main.py:125-140: (X float32, Y 1-based categories)."""
    f = {
        "r6d": f"r6d_{key}.pkl",
        "grouped_r6d": f"Truer6d_{key}.pkl",
        "wordBert": f"{key}_wordBert_embeddings.pkl",
        "groupedWordBert": f"True{key}_wordBert_embeddings.pkl",
        "groupedxy": f"True_confFalse_xy_{key}.pkl",
    }
    X = load_binary(f"{data_dir}/{f[data_type]}")
    Y = (
        load_binary(f"{data_dir}/Truecategs_{key}.pkl")
        if "grouped" in data_type
        else load_binary(f"{data_dir}/categs_{key}.pkl")
    )
    if data_type not in ("wordBert", "groupedWordBert"):
        X = make_equal_len(
            X, method="cutting+reflect", maxpad=192 * (1 + 10 * (data_type == "grouped_r6d"))
        )
        # Y is a plain category list here, like the reference (main.py:135)
        X, Y, _ = rmv_clips_nan(X, list(Y))
    else:
        X = np.asarray(X)
    return np.asarray(X, np.float32), np.asarray(Y)


class ClassifierTrainer:
    """Steps and epoch loops around a classifier module, on the module's
    device.  ``optimizer`` is 'Adam', 'AdamW' or 'NAdam' as the JAX package
    builds them (``train/optim.py``); ``dropout_seed`` seeds the generator
    of the inter-layer dropout masks; ``mesh`` makes the train step data
    parallel (module docstring)."""

    def __init__(self, module, learning_rate: float = 1e-4, weight_decay: float = 1e-3,
                 optimizer: str = "Adam", last_timestep_only: bool = True,
                 dropout_seed: int = 2, mesh=None):
        self.module = module
        self.mesh = mesh
        if mesh is not None:
            mesh.check_device(next(module.parameters()).device)
            self._rows = mesh_lib.RowShard()
            set_dropout_rows(module, self._rows)
            mesh_lib.replicate(module, mesh)
        self.last_timestep_only = last_timestep_only
        self.device = next(module.parameters()).device
        self.opt = make_optimizer(optimizer, module.parameters(), learning_rate,
                                  weight_decay)
        self.dropout_generator = torch.Generator(device=self.device)
        self.dropout_generator.manual_seed(dropout_seed)
        set_dropout_generator(module, self.dropout_generator)

    def _logits(self, x):
        y = self.module(x)
        if self.last_timestep_only and y.dim() == 3:
            y = y[:, -1, :]
        return y

    # ------------------------------------------------------------------
    # steps: x (B, T, D) or (B, D), labels (B,) 0-based, on the device
    # ------------------------------------------------------------------
    def train_step(self, x, labels):
        """One update; returns (loss, correct count) as device tensors.
        Under a mesh ``x``/``labels`` are the global batch (or
        ``shard_batch``'s rows), and both results are global."""
        sharded = False
        if self.mesh is not None:
            (x, labels), sharded = mesh_lib.local_rows((x, labels), self.mesh)
            self._rows.set(self.mesh if sharded else None)
        self.module.train()
        with span("classif.train_step"), conv_matmul_precision("float32"):
            count("classif.frames", _frames(x))
            with span("classif.forward"):
                logits = self._logits(x)
                loss = F.cross_entropy(logits, labels)
            with span("classif.optim"):
                self.opt.zero_grad(set_to_none=True)
            with span("classif.backward"):
                loss.backward()
            correct = (logits.detach().argmax(-1) == labels).sum()
            with span("classif.optim"):
                loss, correct = self._reduce(loss.detach(), correct, sharded)
                self.opt.step()
        return loss, correct

    def _reduce(self, loss, correct, sharded):
        """Sum the gradients, the loss and the correct count over 'data' in
        one bucket; the gradients and the loss become means, and so does
        the count of a replicated batch (every rank counted all of it)."""
        if self.mesh is None:
            return loss, correct
        grads = [p.grad for p in self.module.parameters() if p.grad is not None]
        bucket = torch.cat([g.reshape(-1) for g in grads]
                           + [loss.reshape(1).float(), correct.reshape(1).float()])
        dist.all_reduce(bucket, group=self.mesh.data_group)
        n = self.mesh.shape["data"]
        bucket[:-1 if sharded else None].div_(n)
        offset = 0
        for g in grads:
            g.copy_(bucket[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
        return bucket[-2], bucket[-1].round().long()

    @torch.no_grad()
    def eval_step(self, x, labels):
        """(loss, correct count, predictions) as device tensors."""
        self.module.eval()
        with span("classif.eval_step"):
            count("classif.frames", _frames(x))
            with conv_matmul_precision("float32"):
                logits = self._logits(x)
                loss = F.cross_entropy(logits, labels)
            pred = logits.argmax(-1)
        return loss, (pred == labels).sum(), pred

    # ------------------------------------------------------------------
    # epochs over host arrays (labels 1-based, shifted here)
    # ------------------------------------------------------------------
    def _batch(self, X, Y, sl):
        with span("classif.h2d"):
            x = torch.from_numpy(np.ascontiguousarray(X[sl])).to(self.device)
            y = torch.from_numpy(np.asarray(Y[sl], np.int64) - 1).to(self.device)
        return x, y

    def train_epoch(self, X, Y, batch_size: int):
        """One pass in order, dropping the last incomplete batch; returns
        (per-step losses, accuracy).  The losses are read once, at the end."""
        n = X.shape[0] // batch_size
        out = [self.train_step(*self._batch(X, Y, slice(b * batch_size, (b + 1) * batch_size)))
               for b in range(n)]
        return _epoch_result(out, n * batch_size)

    def val_epoch(self, X, Y, batch_size: int):
        """(sum of the batch losses, accuracy, (GT, predY)), labels 0-based."""
        n = X.shape[0] // batch_size
        GT, out = [], []
        for b in range(n):
            x, y = self._batch(X, Y, slice(b * batch_size, (b + 1) * batch_size))
            GT += (np.asarray(Y[b * batch_size:(b + 1) * batch_size], np.int64) - 1).tolist()
            out.append(self.eval_step(x, y))
        return _val_result(out, n * batch_size, GT)

    # ------------------------------------------------------------------
    # device-resident epochs: only index vectors cross per epoch
    # ------------------------------------------------------------------
    def stage(self, X, Y):
        """The dataset on the device once, X flattened to (N, prod(trail)),
        labels shifted to 0-based."""
        flat, trail = flatten_rows(np.asarray(X, np.float32))
        return (Staged(torch.from_numpy(np.ascontiguousarray(flat)).to(self.device), trail),
                torch.from_numpy(np.asarray(Y, np.int64) - 1).to(self.device))

    def _gather(self, dX, dY, idx):
        return unflatten_batch(dX.dev.index_select(0, idx), dX.trail), dY.index_select(0, idx)

    def train_epoch_resident(self, dX, dY, order, batch_size: int):
        """``train_epoch`` over staged data in the row order ``order``."""
        n = len(order) // batch_size
        if n == 0:
            return [], 0.0
        perm = torch.as_tensor(np.asarray(order)[: n * batch_size], dtype=torch.int64)
        out = [self.train_step(*self._gather(dX, dY, idx))
               for idx in perm.to(self.device).reshape(n, batch_size)]
        return _epoch_result(out, n * batch_size)

    def val_epoch_resident(self, dX, dY, batch_size: int):
        """``val_epoch`` over staged data, in order."""
        n = int(dX.dev.shape[0]) // batch_size
        out = [self.eval_step(*self._gather(dX, dY, torch.arange(
            b * batch_size, (b + 1) * batch_size, device=self.device))) for b in range(n)]
        return _val_result(out, n * batch_size, dY[: n * batch_size].tolist())

    # ------------------------------------------------------------------
    def checkpoint_payload(self, epoch: int) -> dict:
        """``{'epoch', 'state_dict', 'optimizer'}``: the weights in the
        reference's key layout, the optimizer's moments and step."""
        return {"epoch": int(epoch), "state_dict": self.module.state_dict(),
                "optimizer": self.opt.state_dict()}


def _frames(x):
    """Rows times timesteps of a (B, T, D) batch; rows of a (B, D) one."""
    return x.shape[0] * (x.shape[1] if x.dim() == 3 else 1)


def _epoch_result(out, denom):
    if not out:
        return [], 0.0
    losses, accs = zip(*out)
    return torch.stack(losses).tolist(), int(torch.stack(accs).sum()) / max(denom, 1)


def _val_result(out, denom, GT):
    if not out:
        return 0.0, 0.0, (GT, [])
    losses, accs, preds = zip(*out)
    total = float(sum(torch.stack(losses).tolist()))
    return (total, int(torch.stack(accs).sum()) / max(denom, 1),
            (GT, torch.cat(preds).tolist()))


def dump_gt_pred_csv(GT, predY, path="GT_predY.csv"):
    """Reference main.py:107-115."""
    with open(path, "w", encoding="ISO-8859-1", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(("GT", "predY"))
        wr.writerows(zip_longest(GT, predY, fillvalue=""))
    return path
