"""The port's raw-data entry against the JAX package: OpenPose JSON ingestion,
the native scanner, text ids, dataset assembly, skeleton preprocessing, the
single-clip and long-clip lifting, and the ``process_dataset`` CLI.

Every test reads a tree written by the JAX package's own
``data/synthetic.make_openpose_tree``, the same seed for both packages.
Tolerances: the ingestion is exact (the same parser on the same bytes);
native against json at rtol 1e-6, as tests/test_native_runtime.py holds the
JAX scanner (float32 parses of float64 text); the skeleton preprocessing at
float64 within 1e-12; lifted xyz at the lifting tolerances of
tests/test_torch_lifting.py (x, y and MPJPE 2e-4, z 2e-3: the reference's
initialization is ill-conditioned in z at float32); r6d and bone lengths of
the two packages from the same xyz at tests/test_torch_slice.py's geometry
tolerance (1e-4).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from multimodal_hand_pose_enhancement_for_sign_language_tpu.data import (
    datasets,
    openpose,
    skeleton_preproc,
    synthetic,
    text,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu.data.io import load_binary
from multimodal_hand_pose_enhancement_for_sign_language_tpu.lifting import engine
from multimodal_hand_pose_enhancement_for_sign_language_tpu.runtime import native
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch import (
    process_dataset as t_pd,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data import (
    datasets as t_datasets,
    openpose as t_openpose,
    skeleton_preproc as t_skel,
    synthetic as t_synthetic,
    text as t_text,
    video as t_video,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.lifting import (
    engine as t_engine,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops import (
    kinematics as t_kin,
    rotations as t_rot,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.runtime import (
    native as t_native,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.constants import (
    ARMS,
    HANDS,
    NECK,
)

ROOT = Path(__file__).resolve().parents[1]
PORT = "multimodal_hand_pose_enhancement_for_sign_language_tpu_torch"
ATOL = 2e-4  # test_pallas_kernels.py:139 (x, y and per-joint error)
Z_ATOL = 2e-3  # z, float32-ill-conditioned (test_torch_lifting.py)
GEOM_ATOL = 1e-4  # test_kinematics.py:52, test_torch_slice.py's stage tolerance
SPLITS = ("train", "val", "test")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Under six test workers torch's CPU threads oversubscribe the cores
    (tests/test_torch_classifier.py); the lifting runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("raw"))
    synthetic.make_openpose_tree(root, n_videos=3, utts_per_video=2, frames=20, seed=3)
    return root


def _json_dir(root, split="train"):
    return os.path.join(root, split, "rgb_front/features/openpose_output/json")


def _utt_dir(root):
    d = _json_dir(root)
    return os.path.join(d, sorted(os.listdir(d))[0])


def _assert_lists_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("use_native", [True, False])
def test_load_utterance_equals_jax(tree, use_native):
    ours = t_openpose.load_utterance(_utt_dir(tree), use_native=use_native)
    ref = openpose.load_utterance(_utt_dir(tree), use_native=use_native)
    _assert_lists_equal(ours, ref)
    assert ours[0].shape == (20, 75) and ours[1].shape == (20, 126)


def test_native_matches_json_and_counts(tree):
    before = dict(t_openpose.FRAMES)
    in_n, out_n = t_openpose.load_utterance(_utt_dir(tree), use_native=True)
    in_p, out_p = t_openpose.load_utterance(_utt_dir(tree), use_native=False)
    np.testing.assert_allclose(in_n, in_p, rtol=1e-6)
    np.testing.assert_allclose(out_n, out_p, rtol=1e-6)
    assert t_openpose.FRAMES["native"] == before["native"] + 20
    assert t_openpose.FRAMES["json"] == before["json"] + 20


def test_native_scanner_builds_outside_the_package(tree):
    assert t_native.native_available()
    lib = t_native.library()
    assert lib.exists() and lib.parent == ROOT / "build" / "native"
    assert not list((ROOT / PORT / "runtime").glob("*.so"))
    frame = os.path.join(_utt_dir(tree), sorted(os.listdir(_utt_dir(tree)))[0])
    buf = open(frame, "rb").read()
    for o, r in zip(t_native.parse_openpose_frame_bytes(buf),
                    native.parse_openpose_frame_bytes(buf)):
        np.testing.assert_array_equal(o, r)
    with pytest.raises(ValueError):
        t_native.parse_openpose_frame_bytes(b'{"people": []}')


def test_load_utterances_parallel_and_grouping_equal_jax(tree):
    ids = sorted(os.listdir(_json_dir(tree)))
    before = t_openpose.FRAMES["native"]
    ours = t_openpose.load_utterances_parallel(ids, _json_dir(tree), max_workers=2)
    ref = openpose.load_utterances_parallel(ids, _json_dir(tree), max_workers=2)
    assert t_openpose.FRAMES["native"] == before + 20 * len(ids)
    assert ours[0] == ref[0]
    _assert_lists_equal(ours[1], ref[1])
    _assert_lists_equal(ours[2], ref[2])
    g_ours, g_ref = t_openpose.group_clips(*ours), openpose.group_clips(*ref)
    assert g_ours[0] == g_ref[0] == ["vid00000000", "vid00000001", "vid00000002"]
    for k in (1, 2):
        _assert_lists_equal(g_ours[k], g_ref[k])
    assert t_openpose._groupClips is t_openpose.group_clips
    sel = [(NECK, 1), (ARMS, 1), (HANDS, 2)]
    picked = [t_openpose.select_keypoints(g_ours[k], idx) for idx, k in sel]
    picked_ref = [openpose.select_keypoints(g_ref[k], idx) for idx, k in sel]
    for o, r in zip(picked, picked_ref):
        _assert_lists_equal(o, r)
    _assert_lists_equal(t_openpose.select_keypoints(g_ours[1], ARMS, False),
                        openpose.select_keypoints(g_ref[1], ARMS, False))
    _assert_lists_equal(t_openpose.hconcat_feats(*picked),
                        openpose.hconcat_feats(*picked_ref))
    np.testing.assert_array_equal(t_openpose.get_joints(g_ours[1][0], [1, 4]),
                                  openpose.get_joints(g_ref[1][0], [1, 4]))


def test_one_worker_pool_serves_every_split(tree):
    """process_dataset's shared pool: each split read in it equals the JAX
    package's own pool per split."""
    with t_openpose.worker_pool(2) as pool:
        for split in SPLITS:
            ids = sorted(os.listdir(_json_dir(tree, split)))
            ours = t_openpose.load_utterances_parallel(ids, _json_dir(tree, split), pool=pool)
            ref = openpose.load_utterances_parallel(ids, _json_dir(tree, split), max_workers=2)
            assert ours[0] == ref[0]
            _assert_lists_equal(ours[1], ref[1])


@pytest.mark.parametrize("name", ["a10.b2", "vid-3-x", "12", "c.5e"])
def test_natural_keys_equal_jax(name):
    assert t_openpose.natural_keys(name) == openpose.natural_keys(name)


def _h2s_equal(ours, ref):
    for o, r in zip(ours[:2], ref[:2]):
        _assert_lists_equal(o, r)
    assert ours[2] is None and ref[2] is None
    assert ours[3] == ref[3]


@pytest.mark.parametrize("group_by_clip,subset", [(True, 1.0), (False, 0.5),
                                                  (True, 0.5)])
def test_load_h2s_split_equals_jax(tree, group_by_clip, subset):
    """As tests/test_datasets.py:22-44: grouping, and the subset truncating
    the ids and the categories alike."""
    kw = dict(group_by_clip=group_by_clip, subset=subset, max_workers=2)
    ours = t_datasets._load_h2s_split(t_datasets.DatasetPaths(root=tree), "train", **kw)
    ref = datasets._load_h2s_split(datasets.DatasetPaths(root=tree), "train", **kw)
    _h2s_equal(ours, ref)
    if not group_by_clip:
        assert len(ours[0]) == len(ours[3]) == 3


def test_load_h2s_dataset_equals_jax(tree):
    ours = t_datasets.load_h2s_dataset(t_datasets.DatasetPaths(root=tree), subset=1.0,
                                       max_workers=2)
    ref = datasets.load_h2s_dataset(datasets.DatasetPaths(root=tree), subset=1.0,
                                    max_workers=2)
    assert list(ours) == list(ref) == ["test", "val", "train"]
    for split in ours:
        _h2s_equal(ours[split], ref[split])
    assert t_datasets.load_H2S_dataset is t_datasets.load_h2s_dataset


def test_dataset_paths_and_video_ids_equal_jax(tmp_path):
    ours = t_datasets.DatasetPaths(root=str(tmp_path), text_template="/abs/{split}.txt")
    ref = datasets.DatasetPaths(root=str(tmp_path), text_template="/abs/{split}.txt")
    for fn in ("json_dir", "text_path", "categ_path", "vid_dir"):
        assert getattr(ours, fn)("val") == getattr(ref, fn)("val")
    for name in ("a.mp4", "b.mp4", "c.txt"):
        (tmp_path / name).write_text("")
    assert sorted(t_video.get_vid_ids(str(tmp_path))) == ["a", "b"]
    assert sorted(t_datasets._join_ids(["a", "b", "c"], ["b", "c", "d"])) == ["b", "c"]


def test_text_equals_jax(tree):
    path = os.path.join(tree, "train.text.id.en")
    ids = t_text.get_clip_ids(path)
    assert ids == text.get_clip_ids(path)
    for group in (False, True):
        assert (t_text.load_text(path, ids[1:], groupByClip=group)
                == text.load_text(path, ids[1:], groupByClip=group))
    d = {"vid00000001-10-a": "x\n", "vid00000001-2-a": "y\n", "vid00000000-0-a": "z"}
    assert t_text._group_by_clip(d) == text._group_by_clip(d)
    emb = np.random.RandomState(0).randn(5, 7)
    np.testing.assert_array_equal(t_text.average_embeds(emb), text.average_embeds(emb))
    assert t_text.obtain_embeddings(path, ids, method="precomputed") is None
    if not torch.cuda.is_available():  # a model method runs on the card (the default)
        with pytest.raises(RuntimeError, match="CUDA"):
            t_text.obtain_embeddings(path, ids, method="BERTsentence")


def _skeleton(rng, T):
    xyz = rng.randn(T, 25, 3)
    xyz[:, 0] = [0.0, 1.0, 0.1]  # Neck above MidHip
    xyz[:, 1] = [0.3, 1.3, 0.4]  # Nose in front
    xyz[:, 2] = [0.05, 0.0, 0.0]  # MidHip
    return xyz + rng.randn(T, 1, 3) * 0.05


def test_skeleton_preproc_equals_jax():
    xyz = _skeleton(np.random.RandomState(2), 6)
    np.testing.assert_allclose(t_skel.rotate_clip(xyz), skeleton_preproc.rotate_clip(xyz),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(t_skel.scale_axes(xyz), skeleton_preproc.scale_axes(xyz),
                               rtol=0, atol=1e-12)
    v = np.array([0.2, -0.1, 0.3])
    np.testing.assert_allclose(t_skel._rotvec_apply(v, xyz[0]),
                               skeleton_preproc._rotvec_apply(v, xyz[0]), atol=1e-12)
    assert t_skel.skeleton_parts == skeleton_preproc.skeleton_parts


def _assert_lift_close(ours, ref):
    for o, r in zip(ours, ref):
        assert o.shape == r.shape
        o3, r3 = o.reshape(-1, 50, 3), r.reshape(-1, 50, 3)
        np.testing.assert_allclose(o3[..., :2], r3[..., :2], atol=ATOL)
        np.testing.assert_allclose(o3[..., 2], r3[..., 2], atol=Z_ATOL)
        assert np.linalg.norm(o3 - r3, axis=-1).mean() <= ATOL


def _clip(rng, T):
    kp = rng.uniform(100, 500, size=(T, 150)).astype(np.float32)
    kp[:, 2::3] = rng.uniform(0.5, 1.0, size=(T, 50))
    return kp


def test_lift_clip_and_a_long_clip_equal_jax():
    """A clip of 4500 frames (longer than one block of the card's filter;
    its T-bucket pads it to 4544, masked past 4500) at the production 900
    cycles, the port's CPU path against the JAX fori_loop; and the port's
    single-clip ``lift_clip`` is ``lift_clips`` of one clip."""
    rng = np.random.RandomState(7)
    long_clip, short = _clip(rng, 4500), _clip(rng, 50)
    ours = t_engine.lift_clips([long_clip], n_cycles=900, device="cpu")
    ref = engine.lift_clips([long_clip], n_cycles=900, filter_impl="xla")
    _assert_lift_close(ours, ref)
    one = t_engine.lift_clip(short, n_cycles=100, device="cpu")
    np.testing.assert_array_equal(
        one, t_engine.lift_clips([short], n_cycles=100, device="cpu")[0])
    _assert_lift_close([one], [engine.lift_clip(short, n_cycles=100)])


def test_port_builder_writes_the_jax_tree(tmp_path):
    """The port's builder draws the JAX package's tree from the same
    arguments, and with ``videos`` one video per entry."""
    synthetic.make_openpose_tree(str(tmp_path / "j"), n_videos=2, utts_per_video=1,
                                 frames=3, seed=5)
    t_synthetic.make_openpose_tree(str(tmp_path / "t"), n_videos=2, utts_per_video=1,
                                   frames=3, seed=5)
    for dirpath, _, files in os.walk(tmp_path / "j"):
        for f in files:
            a = os.path.join(dirpath, f)
            assert open(a).read() == open(a.replace(os.sep + "j", os.sep + "t", 1)).read()
    t_synthetic.make_openpose_tree(str(tmp_path / "v"), frames=2, videos=[3, 1],
                                   splits=("val",))
    ids = sorted(os.listdir(_json_dir(str(tmp_path / "v"), "val")))
    assert [i[:11] for i in ids] == ["vid00000000"] * 3 + ["vid00000001"]
    assert not os.path.exists(_json_dir(str(tmp_path / "v"), "train"))


def _run(cmd, cwd, **env):
    proc = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=900,
                          env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                                   **env))
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc


@pytest.fixture(scope="module")
def cli_runs(tree, tmp_path_factory):
    """The root CLI (JAX on the CPU) and the port's (``--device cpu``) on one
    tree, each through its ``__main__``, with relative templates (resolved
    against the dataset root) and 900 cycles."""
    out = tmp_path_factory.mktemp("cli")
    common = ["--dataset_path", tree, "--lift", "--workers", "2", "--n_partitions", "2"]
    _run([sys.executable, str(ROOT / "process_dataset.py"), *common,
          "--data_dir", str(out / "jax")], cwd=str(out), JAX_PLATFORMS="cpu")
    _run([sys.executable, "-m", f"{PORT}.process_dataset", *common,
          "--data_dir", str(out / "port"), "--device", "cpu"], cwd=str(out))
    return out / "jax", out / "port"


def test_cli_writes_the_root_clis_files(cli_runs):
    jax_dir, port_dir = cli_runs
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
    for split in SPLITS:
        for name in (f"xy_{split}.pkl", f"True_confTrue_xy_{split}.pkl"):
            _assert_lists_equal(load_binary(str(port_dir / name)),
                                load_binary(str(jax_dir / name)))
        assert (load_binary(str(port_dir / f"categs_{split}.pkl"))
                == load_binary(str(jax_dir / f"categs_{split}.pkl")))
        assert os.path.samefile(port_dir / f"xy_{split}.pkl",
                                port_dir / f"True_confTrue_xy_{split}.pkl")


@pytest.mark.parametrize("split", SPLITS)
def test_cli_lifts_as_the_root_cli(cli_runs, split):
    """xyz at the lifting tolerances; r6d and (train) bone lengths of the two
    packages from the JAX xyz at the geometry tolerance, and each package's
    pickles those of its own xyz."""
    jax_dir, port_dir = cli_runs
    xyz_ref, xyz = (load_binary(str(d / f"xyz_{split}.pkl")) for d in cli_runs)
    assert [c.shape for c in xyz] == [(40, 150)] * 3
    _assert_lift_close(xyz, xyz_ref)
    r6d_ref = load_binary(str(jax_dir / f"r6d_{split}.pkl"))
    on_ref = t_rot.aa_to_rot6d(t_kin.xyz_to_aa(xyz_ref, device="cpu"), device="cpu")
    for o, r in zip(on_ref, r6d_ref):
        assert o.shape == r.shape == (40, 288)
        np.testing.assert_allclose(o, r, atol=GEOM_ATOL)
    own = t_rot.aa_to_rot6d(t_kin.xyz_to_aa(xyz, device="cpu"), device="cpu")
    _assert_lists_equal(own, load_binary(str(port_dir / f"r6d_{split}.pkl")))
    if split == "train":
        lengths_ref, lengths = (load_binary(str(d / "lengths_train.pkl")) for d in cli_runs)
        np.testing.assert_allclose(t_kin.get_bone_length(xyz_ref), lengths_ref,
                                   atol=GEOM_ATOL)
        np.testing.assert_array_equal(lengths, t_kin.get_bone_length(xyz))
    else:
        assert not os.path.exists(port_dir / f"lengths_{split}.pkl")


def test_cli_refuses_what_is_not_ported(tmp_path):
    """Every option is ported now; the stages that run on the device
    (--lift, --vid_feats, a model --text_method; --device defaults to cuda)
    refuse without a card before anything is written, and --crops, which
    needs none, runs."""
    base = ["--dataset_path", str(tmp_path), "--data_dir", str(tmp_path / "o")]
    if not torch.cuda.is_available():
        for extra in (["--lift"], ["--vid_feats"], ["--text_method", "clip"]):
            with pytest.raises(RuntimeError, match="CUDA"):
                t_pd.main(t_pd.build_parser().parse_args(base + extra))
        assert not (tmp_path / "o").exists()
    t_pd.main(t_pd.build_parser().parse_args(base + ["--crops", "--workers", "1"]))
    assert (tmp_path / "o").is_dir()


def test_resolve_templates_as_the_root_cli(tmp_path, monkeypatch):
    """Relative templates that do not exist from the cwd move under the
    dataset root, both of them; absolute or existing ones stay."""
    monkeypatch.chdir(tmp_path)
    parse = t_pd.build_parser().parse_args
    args = t_pd.resolve_templates(parse(["--dataset_path", "/data"]))
    assert args.text_path_template == "/data/{split}.text.id.en"
    assert args.categ_path_template == "/data/videoID_categoryID_{split}.csv"
    (tmp_path / "train.txt").write_text("")
    args = t_pd.resolve_templates(parse(["--dataset_path", "/data", "--text_path_template",
                                         "{split}.txt"]))
    assert args.text_path_template == "{split}.txt"
    assert args.categ_path_template == "videoID_categoryID_{split}.csv"
    args = t_pd.resolve_templates(parse(["--dataset_path", "/data", "--text_path_template",
                                         "/t/{split}.txt"]))
    assert args.text_path_template == "/t/{split}.txt"
