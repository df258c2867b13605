"""The port's ``process_dataset --crops`` / ``--vid_feats`` against the root
CLI, on an OpenPose tree and its videos written by the JAX package's
``data/synthetic`` (cv2 decodes them here; the card's machine has no cv2).

Crops are equal to the byte; ResNet-50 features (one torchvision-layout
``.pth`` for both CLIs) within 2^-15 of their largest value, the rule of
tests/test_torch_featurizers.py.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from multimodal_hand_pose_enhancement_for_sign_language_tpu.data import (
    synthetic as j_synthetic,
    video as j_video,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu.data.io import load_binary
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch import (
    process_dataset as t_pd,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data import (
    io as t_io,
    synthetic as t_synthetic,
    video as t_video,
)

ROOT = Path(__file__).resolve().parents[1]
PORT = "multimodal_hand_pose_enhancement_for_sign_language_tpu_torch"
SPLITS = ("train", "val", "test")
RESNET_REL = 2.0**-15


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Two one-utterance videos of 4 frames a split, 320x240 mp4s (the hands'
    keypoints fall inside, across and outside the frames), and a ResNet-50
    ``.pth`` with random running statistics."""
    root = tmp_path_factory.mktemp("vtree")
    j_synthetic.make_openpose_tree(str(root), n_videos=2, utts_per_video=1, frames=4, seed=3)
    j_synthetic.make_video_tree(str(root), height=240, width=320, seed=3)
    pth = t_synthetic.write_resnet50_weights(str(root / "resnet50.pth"), seed=1)
    return str(root), pth


def _run(cmd, cwd, **env):
    proc = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=900,
                          env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2",
                                   **env))
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc


@pytest.fixture(scope="module")
def cli_runs(tree, tmp_path_factory):
    """Root (JAX on the CPU) and port (``--device cpu``) CLIs, each with
    ``--crops`` and with ``--vid_feats --resnet_weights``, chunks of one clip."""
    root, pth = tree
    out = tmp_path_factory.mktemp("vcli")
    common = ["--dataset_path", root, "--workers", "1", "--vid_chunk", "1"]
    runs = {}
    for flags in (["--crops"], ["--vid_feats", "--resnet_weights", pth]):
        tag = flags[0][2:]
        _run([sys.executable, str(ROOT / "process_dataset.py"), *common, *flags,
              "--data_dir", str(out / f"jax_{tag}")], cwd=str(out), JAX_PLATFORMS="cpu")
        _run([sys.executable, "-m", f"{PORT}.process_dataset", *common, *flags,
              "--data_dir", str(out / f"port_{tag}"), "--device", "cpu"], cwd=str(out))
        runs[tag] = out / f"jax_{tag}", out / f"port_{tag}"
    return runs


def test_crops_cli_writes_the_root_clis_crops(cli_runs):
    jax_dir, port_dir = cli_runs["crops"]
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
    for split in SPLITS:
        want = load_binary(str(jax_dir / f"{split}_vid_crops.pkl"))
        got = load_binary(str(port_dir / f"{split}_vid_crops.pkl"))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g.shape == (4, 3, 120, 120, 2) and g.dtype == np.uint8
            np.testing.assert_array_equal(g, w)
        assert any(g.any() for g in got) and not all(g.all() for g in got)


@pytest.mark.parametrize("split", SPLITS)
def test_feats_cli_matches_the_root_cli(cli_runs, split):
    jax_dir, port_dir = cli_runs["vid_feats"]
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
    want = load_binary(str(jax_dir / f"{split}_vid_feats.pkl"))
    got = load_binary(str(port_dir / f"{split}_vid_feats.pkl"))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == (4, 2000) and g.dtype == np.float32
        err = float(np.abs(g - w).max())
        assert err <= RESNET_REL * float(np.abs(w).max()), err
    # the chunk files stay, as the root CLI's do
    assert os.path.exists(port_dir / f"{split}_vid_feats_1-2.pkl")


def test_feats_cli_featurizes_a_crops_pickle_without_videos(tree, tmp_path, capsys):
    """A split without videos whose crops pickle is in --data_dir gets its
    features from it: ``obtain_vid_feats``, the library's own numbers."""
    root, pth = tree
    data_dir = tmp_path / "d"
    data_dir.mkdir()
    crops = [np.random.RandomState(5).randint(0, 256, (3, 3, 120, 120, 2)).astype(np.uint8)]
    t_io.save_binary(crops, str(data_dir / "val_vid_crops.pkl"))
    args = t_pd.build_parser().parse_args(
        ["--dataset_path", root, "--data_dir", str(data_dir), "--workers", "1",
         "--vid_feats", "--resnet_weights", pth, "--vid_template", "none/{split}",
         "--device", "cpu"])
    t_pd.main(t_pd.resolve_templates(args))
    got = load_binary(str(data_dir / "val_vid_feats.pkl"))
    want = t_video.obtain_feats_crops_resnet(crops, pth, device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    assert not (data_dir / "train_vid_feats.pkl").exists()
    assert "skipping crops" in capsys.readouterr().out


def test_make_video_tree_draws_the_jax_videos(tmp_path):
    j_synthetic.make_openpose_tree(str(tmp_path / "j"), n_videos=1, frames=3, seed=2)
    t_synthetic.make_openpose_tree(str(tmp_path / "t"), n_videos=1, frames=3, seed=2)
    j_synthetic.make_video_tree(str(tmp_path / "j"), height=48, width=64, seed=4)
    t_synthetic.make_video_tree(str(tmp_path / "t"), height=48, width=64, seed=4)
    vid_dir = Path("train", "rgb_front", "raw_videos")
    names = sorted(os.listdir(tmp_path / "j" / vid_dir))
    assert names == sorted(os.listdir(tmp_path / "t" / vid_dir)) and names
    for n in names:
        a = j_video.load_clip(str(tmp_path / "j" / vid_dir / n))
        b = t_video.load_clip(str(tmp_path / "t" / vid_dir / n))
        assert b.shape == (3, 3, 48, 64)
        np.testing.assert_array_equal(a, b)
