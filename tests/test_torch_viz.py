"""The port's GIF rendering and its CLIs against the JAX package's.

* ``viz/viz_3d.viz`` against the JAX ``viz`` on the same seeded xyz (clips
  of 3 and 4 frames; the port's given as a tensor): the same file names,
  frame counts and durations, and every decoded frame equal; a clip
  holding NaN is refused by both.
* The port's inference CLI with ``--seqs_to_viz 1 --tag t --use_wandb
  --device cpu`` against the root ``inference.py`` on one tiny fixture: the
  same GIF name and frame count, frames equal to the JAX renderer's on the
  port's own xyz, that xyz within the serving budget (1e-3 MPJPE) of the
  root's, the sink's ``inference`` event.
* The port's ``viz_gt`` in both modes against the root ``viz_gt.main``:
  an xyz pickle's GIFs equal, frame for frame; from r6d windows, the same
  GIF names, frame counts and durations, frames equal to the JAX
  renderer's on the port's own xyz, and that xyz of ``save_results``
  within the budget of the root's.
* With matplotlib or PIL blocked in ``sys.modules``, the inference CLI,
  ``viz_gt`` and the replay refuse before any work, naming the package and
  ``--seqs_to_viz 0``; the inference CLI with ``--seqs_to_viz 0`` goes on.

A 192-frame window takes ~40 s to render on the CPU, so the CLI cases
render the first 3 frames of each clip (both packages' ``viz`` wrapped
alike); the renderer itself is held on whole clips above.
"""

import argparse
import functools
import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax

import inference as root_inference
import viz_gt as root_viz_gt
from multimodal_hand_pose_enhancement_for_sign_language_tpu.data import (
    standardize as j_std,
    windows as j_windows,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu.models import (
    registry as j_registry,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu.train import (
    checkpoint as j_ckpt,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu.viz import viz_3d as j_viz
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch import (
    article_replay as t_replay,
    inference as t_inference,
    viz_gt as t_viz_gt,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data import synthetic
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data.io import (
    load_binary,
    save_binary,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.viz import viz_3d

MPJPE_BUDGET = 1e-3  # BASELINE.json, the serving path's end-to-end bound
SIZE = 32  # generator width of the CLI fixture
CLI_FRAMES = 3


def _xyz(seed, lengths=(3, 4)):
    rng = np.random.RandomState(seed)
    return [rng.uniform(-1, 1, size=(T, 150)).astype(np.float32) for T in lengths]


def _gif(path):
    """(frame count, duration, loop, every frame decoded as RGB)."""
    with Image.open(path) as im:
        frames = []
        for i in range(im.n_frames):
            im.seek(i)
            frames.append(np.asarray(im.convert("RGB")))
        return im.n_frames, im.info.get("duration"), im.info.get("loop"), frames


def _same_gifs(got, want):
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    for a, b in zip(got, want):
        ga, gb = _gif(a), _gif(b)
        assert ga[:3] == gb[:3], (a, ga[:3], gb[:3])
        for fa, fb in zip(ga[3], gb[3]):
            np.testing.assert_array_equal(fa, fb)


def _mpjpe(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm((a - b).reshape(*a.shape[:-1], 50, 3), axis=-1).mean())


def test_viz_matches_jax(tmp_path):
    xyz = _xyz(0)
    want = j_viz.viz(xyz, frame_rate=2, results_dir=str(tmp_path / "jax"))
    got = viz_3d.viz([torch.from_numpy(c) for c in xyz], frame_rate=2,
                     results_dir=str(tmp_path / "port"))
    assert [os.path.basename(p) for p in got] == ["0.gif", "1.gif"]
    _same_gifs(got, want)
    assert [_gif(p)[0] for p in got] == [3, 4]
    bad = _xyz(1, (2,))
    bad[0][1, 5] = np.nan
    with pytest.raises(ValueError, match="clip 0 holds NaN"):
        viz_3d.viz(bad, results_dir=str(tmp_path / "bad"))
    with pytest.raises(AssertionError):
        j_viz.viz(bad, results_dir=str(tmp_path / "bad"))


@pytest.fixture
def short_gifs(monkeypatch):
    """Both packages' ``viz`` on the first CLI_FRAMES frames of each clip."""
    for module in (viz_3d, j_viz):
        real = module.viz
        monkeypatch.setattr(module, "viz", functools.partial(
            lambda xyz, real=real, **kw: real([np.asarray(c)[:CLI_FRAMES] for c in xyz], **kw)))


def _fixture(tmp_path):
    """r6d/xyz pickles, a JAX .pkl checkpoint of a narrow v1 and its
    standardization statistics."""
    data, models = tmp_path / "data", tmp_path / "models"
    synthetic.make_r6d_dataset(str(data), n_clips=6, t_range=(60, 230), seed=5,
                               save_image_feats=False, device="cpu")
    w = j_windows.make_equal_len(load_binary(str(data / "r6d_train.pkl")),
                                 method="cutting+reflect")
    stats = j_std.calc_standard(w[:, :, :36].transpose(0, 2, 1),
                                w[:, :, 36:288].transpose(0, 2, 1), "arm2wh")
    models.mkdir()
    j_std.save_standardization(str(models / "demoarm2wh_preprocess_core.npz"), *stats)
    module = j_registry.build_generator("v1", 36, 252, default_size=SIZE)
    variables = j_registry.init_generator(module, jax.random.PRNGKey(3), T=192)
    ckpt = str(models / "demo_checkpoint.pkl")
    j_ckpt.save_checkpoint(ckpt, {"epoch": 1, "state": {
        "g_params": variables["params"], "g_stats": variables["batch_stats"]}})
    return data, ckpt


def test_inference_cli_renders_as_the_root_cli(tmp_path, monkeypatch, short_gifs, capsys):
    data, ckpt = _fixture(tmp_path)
    common = ["--checkpoint", ckpt, "--data_dir", str(data), "--exp_name", "demo",
              "--batch_size", "2", "--seqs_to_viz", "1", "--tag", "t", "--use_wandb"]
    out = {}
    for name, cli, extra in (
            ("port", t_inference, ["--device", "cpu", "--default_size", str(SIZE)]),
            ("jax", root_inference, ["--matmul_precision", "float32"])):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)  # GIFs, metrics, root.pkl land here
        if cli is root_inference:
            monkeypatch.setattr(root_inference.registry, "build_generator",
                                functools.partial(j_registry.build_generator,
                                                  default_size=SIZE))
        cli.main(cli.build_parser().parse_args(common + extra + ["--base_path", "."]))
        assert "rendered 1 GIFs" in capsys.readouterr().out
        with open("metrics_demo.jsonl") as f:
            out[name] = [json.loads(line) for line in f]
    assert [{k: r[k] for k in ("event", "gifs")} for r in out["port"]] == \
        [{k: r[k] for k in ("event", "gifs")} for r in out["jax"]] == \
        [{"event": "inference", "gifs": 1}]
    gif = [tmp_path / n / "viz_results_demo_test" / "0.gif" for n in ("port", "jax")]
    assert sorted(os.listdir(gif[0].parent)) == sorted(os.listdir(gif[1].parent)) == ["0.gif"]
    assert _gif(gif[0])[:3] == _gif(gif[1])[:3]  # frames, duration, loop
    assert _gif(gif[0])[0] == CLI_FRAMES
    xyz = [load_binary(str(tmp_path / n / "results_demo" / "xyz_test.pkl")) for n in ("port", "jax")]
    assert _mpjpe(xyz[0], xyz[1]) <= MPJPE_BUDGET
    # the CLI rendered the port's xyz as the JAX renderer does
    _same_gifs([str(gif[0])], j_viz.viz(xyz[0][:1], results_dir=str(tmp_path / "again")))


def test_inference_cli_has_every_root_flag():
    """Every option of the root inference.py, with its default (the port's
    own ``--matmul_precision`` default is float32, TF32 off)."""
    def options(parser):
        return {a.dest: a.default for a in parser._actions if a.option_strings and a.dest != "help"}

    root, port = options(root_inference.build_parser()), options(t_inference.build_parser())
    assert set(root) <= set(port)
    assert {k: port[k] for k in root if k != "matmul_precision"} == \
        {k: v for k, v in root.items() if k != "matmul_precision"}
    assert set(port) - set(root) == {"default_size", "device"}


def _root_viz_gt_args(**kw):
    args = argparse.Namespace(base_path="./", file_path="", seqs_to_viz=20, pipeline="arm2wh",
                              results_dir="viz_results", data_dir="video_data",
                              infer_set="test", exp_name="experiment")
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def test_viz_gt_file_mode_matches_root(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    save_binary(_xyz(2, (3, 2, 4)), str(tmp_path / "xyz.pkl"))
    argv = ["--file_path", str(tmp_path / "xyz.pkl"), "--seqs_to_viz", "2"]
    got = t_viz_gt.main(t_viz_gt.build_parser().parse_args(argv + ["--results_dir", "port"]))
    want = root_viz_gt.main(_root_viz_gt_args(file_path=str(tmp_path / "xyz.pkl"),
                                              seqs_to_viz=2, results_dir="jax"))
    assert [_gif(p)[0] for p in got] == [3, 2]
    _same_gifs(got, want)


@pytest.mark.parametrize("results_dir", ["viz_results", "given"])
def test_viz_gt_window_mode_matches_root(tmp_path, monkeypatch, short_gifs, results_dir):
    data = tmp_path / "data"
    synthetic.make_r6d_dataset(str(data), n_clips=6, t_range=(60, 230), seed=6,
                               save_image_feats=False, device="cpu")
    common = dict(data_dir=str(data), seqs_to_viz=2, exp_name="gt", results_dir=results_dir)
    xyz, gifs = {}, {}
    for name in ("port", "jax"):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        if name == "port":
            argv = [f"--{k}={v}" for k, v in common.items()] + ["--device", "cpu"]
            gifs[name] = t_viz_gt.main(t_viz_gt.build_parser().parse_args(argv))
        else:
            gifs[name] = root_viz_gt.main(_root_viz_gt_args(**common))
        gifs[name] = [os.path.abspath(p) for p in gifs[name]]  # relative to this cwd
        xyz[name] = load_binary(str(tmp_path / name / "results_gt_test" / "xyz_test.pkl"))
        want_dir = "viz_results_gt_test" if results_dir == "viz_results" else results_dir
        assert sorted(os.listdir(want_dir)) == ["0.gif", "1.gif"]
    assert [p.split(os.sep)[-2:] for p in gifs["port"]] == \
        [p.split(os.sep)[-2:] for p in gifs["jax"]]
    assert [_gif(p)[:3] for p in gifs["port"]] == [_gif(p)[:3] for p in gifs["jax"]]
    # the port's xyz rendered as the JAX renderer does (the two xyz differ in
    # float32 rounding, which moves a few antialiased pixels by one level)
    _same_gifs(gifs["port"], j_viz.viz(xyz["port"], results_dir=str(tmp_path / "again")))
    assert np.asarray(xyz["port"]).shape == (2, 192, 150)
    assert _mpjpe(xyz["port"], xyz["jax"]) <= MPJPE_BUDGET


def _refused(tmp_path, cli):
    work = tmp_path / "work"
    if cli == "inference":
        args = t_inference.build_parser().parse_args(
            ["--data_dir", str(work), "--checkpoint", str(work / "c.pth"), "--device", "cpu"])
        return lambda: t_inference.main(args)
    if cli == "viz_gt":
        save_binary(_xyz(3, (2,)), str(tmp_path / "xyz.pkl"))
        args = t_viz_gt.build_parser().parse_args(
            ["--file_path", str(tmp_path / "xyz.pkl"), "--results_dir", str(work)])
        return lambda: t_viz_gt.main(args)
    args = t_replay.build_parser().parse_args(
        ["--scale", "tiny", "--work_dir", str(work), "--out", str(work / "AR.json"),
         "--device", "cpu"])
    return lambda: t_replay.main(args)


@pytest.mark.parametrize("cli", ["inference", "viz_gt", "article_replay"])
@pytest.mark.parametrize("package", ["matplotlib", "PIL"])
def test_without_the_packages_the_clis_refuse_before_any_work(tmp_path, monkeypatch,
                                                                package, cli):
    run = _refused(tmp_path, cli)
    monkeypatch.setitem(sys.modules, package, None)  # any import of it raises
    with pytest.raises(RuntimeError, match=f"needs {package}.*--seqs_to_viz 0"):
        run()
    assert not (tmp_path / "work").exists()
    if cli == "inference":  # with --seqs_to_viz 0 it goes on to its data
        args = t_inference.build_parser().parse_args(
            ["--data_dir", str(tmp_path / "work"), "--seqs_to_viz", "0", "--device", "cpu"])
        with pytest.raises(FileNotFoundError):
            t_inference.main(args)
