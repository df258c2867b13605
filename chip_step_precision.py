#!/usr/bin/env python3
"""Where a float32 training step on the card loses accuracy.

    python3 chip_step_precision.py [--parts d_split,grads,...] [--ways native,per_sample]
                                   [--out build/step_precision.jsonl]

On the batches ``chip_smoke.py`` holds its step checks on (its lifted
synthetic clips, its seeded text and image features), for v1, v4+text,
v4_deeper+text and b2h+image with dropout 0, against a float64
evaluation of the same weights and batch on the CPU, under these ways of
computing: the CPU at float32 (``cpu32``), the card with cuDNN off, what
the trainer runs (``native``: each convolution one whole-batch matrix
product, ``ops/conv``), cuDNN with its default choice of algorithms
(``cudnn``), cuDNN held to deterministic ones (``cudnn_det``), cuDNN
timing its algorithms and keeping the fastest (``cudnn_bench``), and
PyTorch's own CUDA convolutions, im2col and a product one sample at a
time (``per_sample``: cuDNN off, the form's predicate off); TF32 off
throughout.
Prints, per model:

  * each layer's output of the generator's forward (eval and train mode),
    max |err| over max |float64 output|, per way;
  * the gradients of one G and one D step, tensor by tensor, each way's
    error against float64 over the CPU's float32 error in that tensor;
  * the D step's gradient with the generator and the discriminator run
    each way separately, to tell which of the two loses it;
  * the kernels cuDNN runs for each convolution of the generator
    (forward and backward, from the profiler);
  * the ms of a G, a D and a val step on the card, each way;
  * ``chip_smoke.py``'s held check of the trainer's own G and D steps,
    passed or not.

Every row also goes to ``--out`` as a JSON line.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile

import numpy as np
import torch
from torch import nn

import chip_smoke as cs
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data import io
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.infer import (
    conv_matmul_precision,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops import conv
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.train import (
    data as data_lib,
    gan,
)

WAYS = ("cpu32", "native", "cudnn", "cudnn_det", "cudnn_bench", "per_sample")
MODELS = (("v1", None), ("v4", "text"), ("v4_deeper", "text"), ("b2h", "image"))
LAYER_TYPES = (nn.Conv1d, nn.ConvTranspose1d, nn.Linear, nn.BatchNorm1d)
OUT = None


def emit(kind, row):
    row = {"row": kind, **row}
    print(json.dumps(row), flush=True)
    if OUT is not None:
        OUT.write(json.dumps(row) + "\n")
        OUT.flush()


def way_device(way):
    return "cpu" if way in ("cpu32", "cpu64") else "cuda"


@contextlib.contextmanager
def computing(way):
    """TF32 off; cuDNN off, on, deterministic or benchmarking its
    algorithms (``torch.backends.cudnn.benchmark``) as ``way`` says; for
    ``per_sample`` the whole-batch form's predicate off too."""
    flags = {"native": dict(enabled=False), "per_sample": dict(enabled=False),
             "cudnn_det": dict(enabled=True, deterministic=True),
             "cudnn_bench": dict(enabled=True, benchmark=True)}.get(
                 way, dict(enabled=True))
    batched = conv.batched
    if way == "per_sample":
        conv.batched = lambda x: False
    try:
        with conv_matmul_precision("float32"), torch.backends.cudnn.flags(
                **{"benchmark": False, "deterministic": False, "allow_tf32": False,
                   **flags}):
            yield
    finally:
        conv.batched = batched


def trainer(model, cond, way):
    cfg = gan.GanConfig(model=model, loss="RobustLoss", disc_label_smooth=True,
                        dropout_rate=0.0, **cs._cond_kwargs(cond))
    tr = gan.GanTrainer(cfg, device=way_device(way))
    if way == "cpu64":
        for m in (tr.generator, tr.discriminator, tr.adaptive):
            m.double()
    return tr


def raw_step(tr, kind):
    """The trainer's ``kind`` step without its own switches (TF32 and cuDNN
    off), so that ``computing`` decides how it runs."""
    fn = getattr(type(tr), {"g": "g_step", "d": "d_step"}[kind]).__wrapped__
    return lambda *args: fn(tr, *args)


def tensors(batch, way):
    dtype = torch.float64 if way == "cpu64" else torch.float32
    return [None if a is None else torch.from_numpy(a).to(way_device(way), dtype)
            for a in batch]


def layer_outputs(model, cond, batch, way, train):
    """{layer name: its output, float64 on the CPU} of one forward."""
    tr = trainer(model, cond, way)
    net = tr.generator.train(train)
    x, _, f = tensors(batch, way)
    outs, hooks = {}, []
    for name, m in net.named_modules():
        if isinstance(m, LAYER_TYPES):
            hooks.append(m.register_forward_hook(
                lambda mod, i, o, name=name: outs.__setitem__(
                    name, o.detach().double().cpu())))
    with computing(way), torch.no_grad():
        outs["<output>"] = net(x.transpose(1, 2), f).double().cpu()
    for h in hooks:
        h.remove()
    return outs


def forward_rows(model, cond, batch):
    for train in (False, True):
        ref = layer_outputs(model, cond, batch, "cpu64", train)
        got = {w: layer_outputs(model, cond, batch, w, train) for w in WAYS}
        for name, r in ref.items():
            scale = float(r.abs().max())
            emit("forward", {
                "model": model, "conditioning": cond, "train": train, "layer": name,
                "shape": list(r.shape), "ref_abs_max": scale,
                **{w: float((got[w][name] - r).abs().max()) / max(scale, 1e-30)
                   for w in WAYS}})


def step_grads(model, cond, batch, kind, way):
    tr = trainer(model, cond, way)
    with computing(way):
        loss = float(raw_step(tr, kind)(*tensors(batch, way)))
    module = tr.generator if kind == "g" else tr.discriminator
    return loss, {k: p.grad.double().cpu() for k, p in module.named_parameters()
                  if p.grad is not None}


def step_rows(model, cond, batch):
    for kind in ("g", "d"):
        _, ref = step_grads(model, cond, batch, kind, "cpu64")
        got = {w: step_grads(model, cond, batch, kind, w) for w in WAYS}
        err = {w: {k: float((g[k] - ref[k]).abs().max()) for k in ref}
               for w, (_, g) in got.items()}
        for k in ref:
            emit("grad", {"model": model, "conditioning": cond, "step": kind,
                          "tensor": k, "shape": list(ref[k].shape),
                          "ref_abs_max": float(ref[k].abs().max()),
                          **{w: err[w][k] for w in WAYS},
                          **{f"{w}/cpu32": err[w][k] / max(err["cpu32"][k], 1e-30)
                             for w in WAYS if w != "cpu32"}})
        emit("grad_summary", {
            "model": model, "conditioning": cond, "step": kind,
            "loss": {w: l for w, (l, _) in got.items()},
            "max_err": {w: max(err[w].values()) for w in WAYS},
            "max_ratio_to_cpu32": {w: max(err[w][k] / max(err["cpu32"][k], 1e-30)
                                          for k in ref) for w in WAYS if w != "cpu32"}})


def d_split_grads(model, cond, batch, g_way, d_way):
    """The D step's gradient with the generator computed ``g_way`` and the
    discriminator ``d_way`` (both on the card, or both float64 on the CPU).
    Returns (fake, grads)."""
    dev = way_device(d_way)
    trg = trainer(model, cond, g_way)
    trd = trainer(model, cond, d_way)
    x, _, f = tensors(batch, g_way)
    _, y, _ = tensors(batch, d_way)
    trg.generator.eval()
    with computing(g_way), torch.no_grad():
        fake = trg.generator(x.transpose(1, 2), f)
    fake = fake.to(dev, y.dtype)
    D = trd.discriminator.train()
    with computing(d_way):
        loss = (gan.mse(D(gan.calc_motion(fake)), 0.1)
                + gan.mse(D(gan.calc_motion(y.transpose(1, 2))), 0.9))
        grads = torch.autograd.grad(loss, list(D.parameters()))
    names = [k for k, _ in D.named_parameters()]
    return fake.double().cpu(), {k: g.double().cpu() for k, g in zip(names, grads)}


def d_split_rows(model, cond, batch):
    fake_ref, ref = d_split_grads(model, cond, batch, "cpu64", "cpu64")
    scale = float(fake_ref.abs().max())
    for g_way, d_way in (("native", "native"), ("native", "cudnn_det"),
                         ("cudnn_det", "native"), ("cudnn_det", "cudnn_det"),
                         ("cudnn_bench", "cudnn_bench"), ("per_sample", "per_sample")):
        if g_way not in WAYS or d_way not in WAYS:
            continue
        fake, got = d_split_grads(model, cond, batch, g_way, d_way)
        emit("d_split", {
            "model": model, "conditioning": cond, "generator": g_way,
            "discriminator": d_way,
            "fake_err_over_max": float((fake - fake_ref).abs().max()) / scale,
            "grad_err": max(float((got[k] - ref[k]).abs().max()) for k in ref),
            "grad_err_at": max(ref, key=lambda k: float((got[k] - ref[k]).abs().max()))})


def kernel_rows(model, cond, batch):
    """The CUDA kernels of each generator convolution, forward and backward."""
    from torch.profiler import ProfilerActivity, profile

    tr = trainer(model, cond, "cudnn")
    net = tr.generator.train()
    x, _, f = tensors(batch, "cudnn")
    inputs = {}
    hooks = [m.register_forward_hook(
        lambda mod, i, o, name=name: inputs.__setitem__(name, (mod, i[0].detach())))
        for name, m in net.named_modules()
        if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d))]
    with computing("cudnn"), torch.no_grad():
        net(x.transpose(1, 2), f)
    for h in hooks:
        h.remove()
    for name, (mod, inp) in inputs.items():
        for way in (w for w in WAYS if w.startswith("cudnn")):
            inp = inp.clone().requires_grad_(True)
            with computing(way):
                out = mod(inp)
                grad = torch.randn_like(out)
                out.backward(grad)  # warm-up: cuDNN picks its plans here
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    mod(inp).backward(grad)
                    torch.cuda.synchronize()
            names = sorted({e.name[:90] for e in prof.events()
                            if e.device_type == torch.autograd.DeviceType.CUDA})
            emit("kernels", {"model": model, "conditioning": cond, "layer": name,
                             "way": way, "input": list(inp.shape),
                             "weight": list(mod.weight.shape), "kernels": names})


def timing_rows(model, cond, batch):
    """ms of a G, a D and a val step (B=128, val B=64), each way on the card."""
    for way in WAYS[1:]:
        tr = trainer(model, cond, way)
        args = tensors(batch, way)
        half = [None if a is None else a[: len(a) // 2] for a in args]
        steps = {"g": (raw_step(tr, "g"), args), "d": (raw_step(tr, "d"), args),
                 "val": (type(tr).val_step.__wrapped__.__get__(tr), half)}
        with computing(way):
            ms = {k: cs.cuda_ms(lambda: fn(*a), reps=5, warmup=2)
                  for k, (fn, a) in steps.items()}
        emit("step_ms", {"model": model, "conditioning": cond, "way": way, **ms})


def check_rows(model, cond, batch):
    """chip_smoke's held step check of the trainer's own step, G and D,
    reported whether it passes or not."""
    x, y, f = batch
    for kind in ("g", "d"):
        try:
            cs.step_against_cpu(kind, x, y, model, cond, f)
            emit("check", {"model": model, "conditioning": cond, "step": kind,
                           "passed": True})
        except AssertionError as e:
            emit("check", {"model": model, "conditioning": cond, "step": kind,
                           "passed": False, "why": str(e)[:2000]})


PARTS = {"d_split": d_split_rows, "grads": step_rows, "forward": forward_rows,
         "kernels": kernel_rows, "timing": timing_rows, "checks": check_rows}


def batches():
    """chip_smoke's step-check batches: {(model, cond): (x, y, feats)}."""
    cs.build_kernels(("filter_sgd",))
    clips = cs.synthetic_clips(np.random.RandomState(cs.SEED), cs.N_CLIPS)
    xyz, r6d = cs.lift_to_r6d(clips)
    out = {}
    with tempfile.TemporaryDirectory(prefix="step_precision_") as tmp:
        v1_dir = os.path.join(tmp, "v1")
        os.makedirs(v1_dir)
        io.save_binary(list(r6d), os.path.join(v1_dir, "r6d_train"))
        io.save_binary(list(r6d[-cs.N_VAL_CLIPS:]), os.path.join(v1_dir, "r6d_val"))
        data = data_lib.load_data(v1_dir, "arm2wh", os.path.join(tmp, "stats"), "v1",
                                  np.random.RandomState(23456), base_path=tmp)
        B = cs.TRAIN_BATCH
        out[("v1", None)] = (data["train_X"][:B], data["train_Y"][:B], None)
        cond_dir = os.path.join(tmp, "cond")
        os.makedirs(cond_dir)
        cs.write_conditioned_data(cond_dir, xyz, r6d, np.random.default_rng(cs.SEED + 2))
        for cond in ("text", "image"):
            data = data_lib.load_data(
                cond_dir, "arm2wh", os.path.join(tmp, "stats"), "cond",
                np.random.RandomState(23456), base_path=tmp, **cs._cond_kwargs(cond))
            batch = tuple(np.ascontiguousarray(data[k][:B])
                          for k in ("train_X", "train_Y", "train_feats"))
            for model, c in MODELS:
                if c == cond:
                    out[(model, cond)] = batch
    return out


def main() -> int:
    global OUT, WAYS
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="build/step_precision.jsonl")
    p.add_argument("--parts", default=",".join(PARTS))
    p.add_argument("--ways", default=",".join(WAYS),
                   help="ways to compute besides float64 (cpu32 is always one)")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("chip_step_precision: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    OUT = open(args.out, "w")
    print(cs.nvidia_smi(), flush=True)
    WAYS = ("cpu32", *(w for w in args.ways.split(",") if w != "cpu32"))
    for (model, cond), batch in batches().items():
        for part in args.parts.split(","):
            PARTS[part](model, cond, batch)
    OUT.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
