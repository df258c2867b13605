"""The port's conditioned training and serving on the CPU, against the JAX
package's root CLIs.

One synthetic r6d dataset with sentence embeddings and per-frame image
features (the JAX package's ``data/synthetic``, ``save_image_feats=True``)
serves both packages.  Checked:

* ``train.data.load_data`` with text (normal and average embeddings) and
  with image features gives the JAX package's arrays, features, statistics
  and order; per-frame features through the fused window pass equal the
  JAX package's equalize-then-drop chain, and a NaN in a clip's feature
  window drops that clip;
* the port's ``train_gan`` CLI, 2 epochs of v4 ``--require_text`` (host
  batches) and of b2h ``--require_image`` (resident), from the JAX
  trainer's initial weights with dropout 0: per-epoch train and val losses
  within 1e-5 relative of the root ``train_gan.main`` (the tolerance of
  tests/test_torch_train_cli.py);
* the port's ``inference`` CLI serving each run's ``.pth`` and the root
  run's JAX ``.pkl``: the same error as the root ``inference.main`` on that
  checkpoint within 1e-5 relative, and result xyz within the 1e-3
  end-to-end budget (BASELINE.json).
"""

import functools
import json
import os

import numpy as np
import pytest

import jax

import inference as root_inference
import train_gan as root_cli
from multimodal_hand_pose_enhancement_for_sign_language_tpu.data import synthetic
from multimodal_hand_pose_enhancement_for_sign_language_tpu.data import (
    windows as j_windows,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu.models import (
    registry as j_registry,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu.train import (
    data as j_data,
    gan as j_gan,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch import (
    inference as t_inference,
    train_gan as t_cli,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data import (
    windows as t_windows,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data.io import (
    load_binary,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models import convert
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.train import (
    checkpoint as t_ckpt,
    data as t_data,
    gan as t_gan,
)

LOSS_RTOL = 1e-5
XYZ_ATOL = 1e-3  # end-to-end budget, BASELINE.json
SIZE = 32
EPOCHS = 2


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cond_cli")
    synthetic.make_r6d_dataset(os.path.join(d, "video_data"), n_clips=12,
                               t_range=(60, 230), seed=13, save_image_feats=True)
    return d


@pytest.mark.parametrize("cond,embeds_type,pipeline", [
    ("text", "normal", "arm2wh"), ("text", "average", "arm2wh"),
    ("image", "normal", "arm2wh"), ("image", "normal", "wh2wh"),
])
def test_load_data_with_features_is_the_jax_packages(workdir, tmp_path, cond,
                                                     embeds_type, pipeline):
    kw = dict(require_text=cond == "text", require_image=cond == "image",
              embeds_type=embeds_type, base_path=str(workdir))
    data_dir = os.path.join(workdir, "video_data")
    a = t_data.load_data(data_dir, pipeline, str(tmp_path / "t"), "x",
                         np.random.RandomState(23456), **kw)
    b = j_data.load_data(data_dir, pipeline, str(tmp_path / "j"), "x",
                         np.random.RandomState(23456), **kw)
    for k in ("train_X", "train_Y", "val_X", "val_Y", "train_feats", "val_feats"):
        assert a[k].dtype == b[k].dtype == np.float32, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    n = len(a["train_X"])
    assert a["train_feats"].shape == ((n, 512) if cond == "text" else (n, 192, 2000))
    name = f"x{pipeline}_preprocess_core.npz"
    with np.load(tmp_path / "t" / name) as f, np.load(tmp_path / "j" / name) as g:
        assert sorted(f.files) == sorted(g.files)
        for k in f.files:
            np.testing.assert_array_equal(f[k], g[k])


def _clips_and_frame_feats(seed, n=6, width=288, feat=40):
    rng = np.random.RandomState(seed)
    lengths = rng.randint(60, 260, size=n)
    lengths[0], lengths[1] = 100, 230  # one reflected, one cut
    clips = [rng.randn(t, width).astype(np.float32) for t in lengths]
    feats = [rng.randn(t, feat).astype(np.float32) for t in lengths]
    return clips, feats


def test_assemble_windows_frame_features_are_the_jax_chain():
    """Per-frame features through the fused pass equal the JAX package's
    make_equal_len of the clips and of the features, then rmv_clips_nan."""
    clips, feats = _clips_and_frame_feats(5)
    x_cols, y_cols = t_windows.pipeline_column_slices("arm2wh")
    X, Y, F, kept = t_windows.assemble_windows(clips, x_cols, y_cols, slice(None),
                                               feats=feats)
    w = j_windows.make_equal_len(clips, method="cutting+reflect")
    f = j_windows.make_equal_len(feats, method="cutting+reflect")
    X2, Y2, F2 = j_windows.rmv_clips_nan(w[:, :, x_cols], w[:, :, y_cols], f)
    assert kept == list(range(len(clips)))
    for got, want in ((X, X2), (Y, Y2), (F, F2)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_assemble_windows_drops_a_nan_in_the_frame_features_window():
    """A NaN inside a clip's 192-frame feature window drops that clip; one
    in frames the cut leaves out does not."""
    clips, feats = _clips_and_frame_feats(6)
    feats[2][10, 3] = np.nan
    feats[1][200, 0] = np.nan  # clip 1 is 230 frames long: cut at 192
    x_cols, y_cols = t_windows.pipeline_column_slices("arm2wh")
    X, _, F, kept = t_windows.assemble_windows(clips, x_cols, y_cols, slice(None),
                                               feats=feats)
    assert kept == [0, 1, 3, 4, 5]
    assert F.shape == (5, 192, 40) and np.isfinite(F).all()
    np.testing.assert_array_equal(F[1], feats[1][:192])


def test_both_feature_flags_load_no_features(workdir, tmp_path):
    """As the JAX package's load_windows: both flags together load none."""
    d = t_data.load_data(os.path.join(workdir, "video_data"), "arm2wh",
                         str(tmp_path), "x", np.random.RandomState(23456),
                         require_text=True, require_image=True,
                         base_path=str(workdir))
    assert d["train_feats"] is None and d["val_feats"] is None


def _args(cli, workdir, exp, **over):
    args = cli.build_parser().parse_args([])
    args.base_path = str(workdir)
    args.data_dir = os.path.join(workdir, "video_data")
    args.model_path = os.path.join(workdir, f"models_{exp}")
    args.num_epochs = EPOCHS
    args.batch_size = 4
    args.exp_name = exp
    args.default_size = SIZE
    args.loss = "RobustLoss"
    args.disc_label_smooth = True
    for k, v in over.items():
        setattr(args, k, v)
    return args


def _series(args, key):
    path = os.path.join(args.model_path, f"metrics_{args.exp_name}.jsonl")
    with open(path) as f:
        return [r[key] for r in map(json.loads, f) if key in r]


# model, its conditioning flag, epoch_scan (resident epochs)
RUNS = {"v4-text": ("v4", "require_text", False),
        "b2h-image": ("b2h", "require_image", True)}


@pytest.fixture(scope="module", params=sorted(RUNS))
def runs(request, workdir):
    """The root CLI and the port's on the same data from the same initial
    weights (handed to the port as a resume checkpoint), dropout 0."""
    model, flag, scan = RUNS[request.param]
    over = dict(model=model, epoch_scan=scan, **{flag: True})
    j_args = _args(root_cli, workdir, "j" + request.param, **over)
    t_args = _args(t_cli, workdir, "t" + request.param, device="cpu",
                   use_checkpoint=True, **over)
    captured = {}
    init_state = j_gan.GanTrainer.init_state

    def recording_init(self, rng=None):
        state = init_state(self, rng)
        captured.update(jax.tree.map(
            np.asarray, {k: v for k, v in state.items() if k != "rng"}))
        return state

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(root_cli, "GanConfig",
                   functools.partial(j_gan.GanConfig, dropout_rate=0.0,
                                     default_size=SIZE))
        mp.setattr(j_gan.GanTrainer, "init_state", recording_init)
        root_cli.main(j_args)
        mp.setattr(t_cli, "GanConfig",
                   functools.partial(t_gan.GanConfig, dropout_rate=0.0))
        tr = t_gan.GanTrainer(t_gan.GanConfig(
            model=model, loss="RobustLoss", default_size=SIZE, dropout_rate=0.0,
            **{flag: True}), device="cpu")
        tr.generator.load_state_dict(convert.generator_state_dict(
            {"params": captured["g_params"], "batch_stats": captured["g_stats"]}),
            strict=True)
        tr.discriminator.load_state_dict(convert.discriminator_state_dict(
            {"params": captured["d_params"], "batch_stats": captured["d_stats"]}),
            strict=True)
        t_ckpt.save_checkpoint(
            os.path.join(t_args.model_path, f"lastCheckpoint_{t_args.exp_name}.pth"),
            tr.checkpoint_payload(0))
        t_cli.main(t_args)
    return j_args, t_args


def test_losses_follow_the_root_cli(runs):
    j_args, t_args = runs
    for key in ("loss_train_gen", "loss_val_gen"):
        a, b = _series(t_args, key), _series(j_args, key)
        assert len(a) == len(b) == EPOCHS, key
        np.testing.assert_allclose(a, b, rtol=LOSS_RTOL, err_msg=key)


def _infer_args(cli, train_args, checkpoint, base_path):
    args = cli.build_parser().parse_args([])
    args.checkpoint = checkpoint
    args.base_path = str(base_path)
    args.data_dir = train_args.data_dir
    args.exp_name = train_args.exp_name
    args.model = train_args.model
    args.require_text = train_args.require_text
    args.require_image = train_args.require_image
    args.batch_size = 4
    return args


@pytest.mark.parametrize("source", ["port-pth", "jax-pkl"])
def test_inference_cli_serves_the_checkpoint_as_the_root_cli(runs, tmp_path,
                                                             monkeypatch, source):
    j_args, t_args = runs
    train_args = t_args if source == "port-pth" else j_args
    ckpt = os.path.join(train_args.model_path,
                        f"{train_args.exp_name}_checkpoint." + source[-3:])
    monkeypatch.chdir(tmp_path)  # both CLIs write root.pkl / bone_len.pkl here
    iargs = _infer_args(t_inference, train_args, ckpt, tmp_path / "port")
    iargs.default_size, iargs.device, iargs.seqs_to_viz = SIZE, "cpu", 0
    err = t_inference.main(iargs)

    rargs = _infer_args(root_inference, train_args, ckpt, tmp_path / "jax")
    rargs.seqs_to_viz, rargs.matmul_precision = 0, "float32"
    monkeypatch.setattr(root_inference.registry, "build_generator",
                        functools.partial(j_registry.build_generator,
                                          default_size=SIZE))
    want = root_inference.main(rargs)
    assert np.isfinite(err)
    np.testing.assert_allclose(err, want, rtol=LOSS_RTOL)
    res = f"results_{train_args.exp_name}"
    got = np.asarray(load_binary(str(tmp_path / "port" / res / "xyz_test.pkl")))
    ref = np.asarray(load_binary(str(tmp_path / "jax" / res / "xyz_test.pkl")))
    assert got.shape == ref.shape and got.shape[1:] == (192, 150)
    np.testing.assert_allclose(got, ref, atol=XYZ_ATOL, rtol=0)


@pytest.mark.parametrize("cli", [t_cli, t_inference], ids=["train_gan", "inference"])
def test_both_feature_flags_are_refused(workdir, cli):
    """Text and image together condition no generator: both CLIs refuse
    them before any work."""
    args = _args(cli, workdir, "both", device="cpu", require_text=True,
                 require_image=True)
    with pytest.raises(ValueError, match="exclude each other"):
        cli.main(args)
    assert not os.path.exists(args.model_path)
