"""The port's training CLI on the CPU, end to end, and against the root CLI.

One synthetic r6d dataset (the JAX package's ``data/synthetic``) serves
both packages.  The port's ``train_gan.main`` runs 4 epochs with dropout
(epochs 0-2 train G and validate, epoch 3 trains D): finite losses, the
three checkpoint files, the stats npz with its (1, D, 1) contract, a
resume, and the port's inference CLI reading the checkpoint.  With dropout
0 and the JAX trainer's initial weights carried across by
``models/convert`` (as a resume checkpoint), the per-epoch train, val and
discriminator losses are held against the root ``train_gan.main`` on the
same data.

Tolerance of that comparison: 1e-5 relative.  The train losses came out
1.4e-7 apart at most when this was written (float32 on the CPU in both);
the room is for the sign flips of noise-sized gradients in Adam's first
steps (see tests/test_torch_gan.py), which move a trajectory by a few lr.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax

import train_gan as root_cli
from multimodal_hand_pose_enhancement_for_sign_language_tpu.data import synthetic
from multimodal_hand_pose_enhancement_for_sign_language_tpu.train import (
    data as j_data,
    gan as j_gan,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch import (
    inference as t_inference,
    train_gan as t_cli,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data.io import (
    load_binary,
    save_binary,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models import convert
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.train import (
    checkpoint as t_ckpt,
    data as t_data,
    gan as t_gan,
)

LOSS_RTOL = 1e-5
SIZE = 32


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    synthetic.make_r6d_dataset(os.path.join(d, "video_data"), n_clips=12,
                               t_range=(60, 230), seed=11, save_image_feats=False)
    return d


def _args(cli, workdir, exp, **over):
    args = cli.build_parser().parse_args([])
    args.base_path = str(workdir)
    args.data_dir = os.path.join(workdir, "video_data")
    args.model_path = os.path.join(workdir, f"models_{exp}")
    args.num_epochs = 4
    args.batch_size = 8
    args.epochs_train_disc = 3
    args.exp_name = exp
    args.default_size = SIZE
    args.loss = "RobustLoss"
    args.disc_label_smooth = True
    for k, v in over.items():
        setattr(args, k, v)
    return args


def _metrics(args):
    path = os.path.join(args.model_path, f"metrics_{args.exp_name}.jsonl")
    with open(path) as f:
        return [json.loads(line) for line in f]


def _series(records, key):
    return [r[key] for r in records if key in r]


def test_load_data_is_the_jax_packages(workdir, tmp_path):
    """The port's copy of load_data gives the same arrays and stats file."""
    a = t_data.load_data(os.path.join(workdir, "video_data"), "arm2wh",
                         str(tmp_path / "t"), "x", np.random.RandomState(23456),
                         base_path=str(workdir))
    b = j_data.load_data(os.path.join(workdir, "video_data"), "arm2wh",
                         str(tmp_path / "j"), "x", np.random.RandomState(23456),
                         base_path=str(workdir))
    for k in ("train_X", "train_Y", "val_X", "val_Y"):
        np.testing.assert_array_equal(a[k], b[k])
    assert a["train_X"].shape[1:] == (192, 36) and a["train_Y"].shape[1:] == (192, 252)
    with np.load(tmp_path / "t" / "xarm2wh_preprocess_core.npz") as f, \
            np.load(tmp_path / "j" / "xarm2wh_preprocess_core.npz") as g:
        assert sorted(f.files) == sorted(g.files)
        for k in f.files:
            np.testing.assert_array_equal(f[k], g[k])


@pytest.mark.parametrize("bad", ["float64", "list"])
def test_load_data_refuses_clips_that_are_not_float32(workdir, tmp_path, bad):
    """Clips that are not float32 arrays take the JAX package's legacy
    route: float64 clips give its float32 arrays bit for bit; clips that
    are not arrays at all raise there as in the JAX package, before
    anything is written."""
    clips = load_binary(os.path.join(workdir, "video_data", "r6d_train.pkl"))
    clips = ([c.astype(np.float64) for c in clips] if bad == "float64"
             else [c.tolist() for c in clips])
    os.makedirs(tmp_path / "video_data")
    for split in ("train", "val"):
        save_binary(clips, str(tmp_path / "video_data" / f"r6d_{split}"))
    args = ("video_data", "arm2wh")
    kw = dict(base_path=str(tmp_path))
    if bad == "list":
        for mod, out in ((t_data, "m"), (j_data, "j")):
            with pytest.raises(AttributeError):
                mod.load_data(*args, str(tmp_path / out), "x", np.random.RandomState(23456), **kw)
        assert not (tmp_path / "m").exists()  # refused before anything is written
        return
    got = t_data.load_data(*args, str(tmp_path / "m"), "x", np.random.RandomState(23456), **kw)
    want = j_data.load_data(*args, str(tmp_path / "j"), "x", np.random.RandomState(23456), **kw)
    for k in ("train_X", "train_Y", "val_X", "val_Y"):
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_load_data_drops_nan_clips_and_keeps_wh2wh_arm_nans(workdir, tmp_path):
    """A NaN in a clip's first 192 frames drops the clip; under wh2wh one
    confined to the arm block does not (the reference slices X first)."""
    clips = [c.copy() for c in load_binary(
        os.path.join(workdir, "video_data", "r6d_train.pkl"))]
    clips[0][3, 100] = np.nan  # a hand column
    clips[1][5, 2] = np.nan  # an arm column
    os.makedirs(tmp_path / "video_data")
    for split in ("train", "val"):
        save_binary(clips, str(tmp_path / "video_data" / f"r6d_{split}"))
    for pipeline, kept in (("arm2wh", len(clips) - 2), ("wh2wh", len(clips) - 1)):
        for pkg in (t_data, j_data):
            d = pkg.load_data("video_data", pipeline, str(tmp_path / "m"), "x",
                              np.random.RandomState(23456), base_path=str(tmp_path))
            assert len(d["train_X"]) == len(d["val_X"]) == kept, (pipeline, pkg)
            assert np.isfinite(d["train_X"]).all() and np.isfinite(d["val_Y"]).all()


@pytest.fixture(scope="module")
def trained(workdir):
    """The port's CLI, 4 epochs with dropout, host batches."""
    args = _args(t_cli, workdir, "drop", device="cpu")
    seen = []

    def hook(epoch, kind, trainer, losses):
        seen.append((epoch, kind, dict(losses)))

    best = t_cli.main(args, epoch_hook=hook)
    return args, best, seen


def test_cli_trains_and_writes_the_contract_files(trained):
    args, best, seen = trained
    assert [(e, k) for e, k, _ in seen] == [(0, "g"), (1, "g"), (2, "g"), (3, "d")]
    assert all(np.isfinite(v) for _, _, losses in seen for v in losses.values())
    assert np.isfinite(best) and best == min(
        l["loss_val_gen"] for _, k, l in seen if k == "g")
    for name in ("drop_checkpoint.pth", "discriminator_drop.pth",
                 "lastCheckpoint_drop.pth", "metrics_drop.jsonl"):
        assert os.path.exists(os.path.join(args.model_path, name)), name
    with np.load(os.path.join(args.model_path, "droparm2wh_preprocess_core.npz")) as f:
        assert f["body_mean_X"].shape == (1, 36, 1)
        assert f["body_std_Y"].shape == (1, 252, 1)
    ckpt = t_ckpt.load_checkpoint(os.path.join(args.model_path, "drop_checkpoint.pth"))
    assert {"epoch", "state_dict", "g_optimizer"} <= set(ckpt)
    disc = t_ckpt.load_checkpoint(os.path.join(args.model_path, "discriminator_drop.pth"))
    assert "convs.29.weight" in disc["state_dict"]
    # the latents were never optimized: still the defaults, bit for bit
    fresh = t_gan.GanTrainer(t_gan.GanConfig(loss="RobustLoss"), device="cpu")
    for k, v in fresh.adaptive.state_dict().items():
        assert torch.equal(ckpt["robust"][k], v)
    records = _metrics(args)
    assert len(_series(records, "loss_train_gen")) == 3
    assert len(_series(records, "loss_train_disc")) == 1


def test_cli_resumes_from_the_last_checkpoint(trained, capsys):
    args, _, _ = trained
    states = []
    resumed = _args(t_cli, args.base_path, "drop", device="cpu", use_checkpoint=True,
                    num_epochs=1)

    def hook(epoch, kind, trainer, losses):
        states.append(trainer)

    saved = t_ckpt.load_checkpoint(
        os.path.join(args.model_path, "lastCheckpoint_drop.pth"))
    step0 = int(next(iter(saved["g_optimizer"]["state"].values()))["step"])
    best = t_cli.main(resumed, epoch_hook=hook)
    assert np.isfinite(best)
    assert "resumed from epoch" in capsys.readouterr().out
    # the resumed run started from the checkpoint's Adam state: its step
    # counter went on from the saved one
    step1 = int(next(iter(states[0].g_opt.state_dict()["state"].values()))["step"])
    assert step0 > 0 and step1 > step0


def test_payload_round_trip_restores_everything(trained):
    args, _, _ = trained
    path = os.path.join(args.model_path, "drop_checkpoint.pth")
    cfg = t_gan.GanConfig(loss="RobustLoss", default_size=SIZE,
                          disc_label_smooth=True)
    a = t_gan.GanTrainer(cfg, device="cpu")
    a.load_checkpoint_payload(t_ckpt.load_checkpoint(path))
    b = t_gan.GanTrainer(cfg, device="cpu")
    b.load_checkpoint_payload(a.checkpoint_payload(7))
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(4, 192, 36).astype(np.float32))
    y = torch.from_numpy(rng.randn(4, 192, 252).astype(np.float32))
    # same weights, Adam moments and dropout stream: the same next steps
    assert float(a.g_step(x, y)) == float(b.g_step(x, y))
    assert float(a.d_step(x, y)) == float(b.d_step(x, y))
    for k, v in a.generator.state_dict().items():
        assert torch.equal(v, b.generator.state_dict()[k]), k


def test_inference_cli_reads_the_trained_checkpoint(trained, monkeypatch):
    args, _, _ = trained
    monkeypatch.chdir(args.base_path)
    iargs = t_inference.build_parser().parse_args([])
    iargs.checkpoint = os.path.join(args.model_path, "lastCheckpoint_drop.pth")
    iargs.base_path = args.base_path
    iargs.data_dir = args.data_dir
    iargs.exp_name = "drop"
    iargs.batch_size = 4
    iargs.default_size = SIZE
    iargs.device = "cpu"
    iargs.seqs_to_viz = 0
    err = t_inference.main(iargs)
    assert np.isfinite(err)
    xyz = load_binary(os.path.join(args.base_path, "results_drop", "xyz_test.pkl"))
    assert np.asarray(xyz).shape[1:] == (192, 150) and np.isfinite(xyz).all()


@pytest.mark.parametrize("epoch_scan", [False, True], ids=["host", "resident"])
def test_losses_follow_the_root_cli_without_dropout(workdir, monkeypatch, epoch_scan):
    exp = "scan" if epoch_scan else "host"
    j_args = _args(root_cli, workdir, "j" + exp, epoch_scan=epoch_scan)
    monkeypatch.setattr(root_cli, "GanConfig",
                        functools.partial(j_gan.GanConfig, dropout_rate=0.0))
    captured = {}
    init_state = j_gan.GanTrainer.init_state

    def recording_init(self, rng=None):
        state = init_state(self, rng)
        captured.update(jax.tree.map(
            np.asarray, {k: v for k, v in state.items() if k != "rng"}))
        return state

    monkeypatch.setattr(j_gan.GanTrainer, "init_state", recording_init)
    root_cli.main(j_args)
    want = _metrics(j_args)

    # the same initial weights, handed to the port as a resume checkpoint
    t_args = _args(t_cli, workdir, "t" + exp, device="cpu",
                   use_checkpoint=True, epoch_scan=epoch_scan)
    monkeypatch.setattr(t_cli, "GanConfig",
                        functools.partial(t_gan.GanConfig, dropout_rate=0.0))
    tr = t_gan.GanTrainer(t_gan.GanConfig(
        loss="RobustLoss", default_size=SIZE, dropout_rate=0.0), device="cpu")
    tr.generator.load_state_dict(convert.generator_state_dict(
        {"params": captured["g_params"], "batch_stats": captured["g_stats"]}))
    tr.discriminator.load_state_dict(convert.discriminator_state_dict(
        {"params": captured["d_params"], "batch_stats": captured["d_stats"]}))
    t_ckpt.save_checkpoint(
        os.path.join(t_args.model_path, f"lastCheckpoint_{t_args.exp_name}.pth"),
        tr.checkpoint_payload(0))
    t_cli.main(t_args)
    got = _metrics(t_args)

    for key, n in (("loss_train_gen", 3), ("loss_val_gen", 3), ("loss_train_disc", 1)):
        a, b = _series(got, key), _series(want, key)
        assert len(a) == len(b) == n, key
        np.testing.assert_allclose(a, b, rtol=LOSS_RTOL, err_msg=key)


@pytest.mark.parametrize("flag,value", [("prng_impl", "rbg")])
def test_unported_flags_raise_and_name_the_roadmap(workdir, flag, value):
    args = _args(t_cli, workdir, "nope", device="cpu", **{flag: value})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_cli.main(args)
    assert not os.path.exists(args.model_path)  # refused before any work


def test_cli_defaults_to_cuda(workdir):
    args = _args(t_cli, workdir, "gpu")
    assert args.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_cli.main(args)
