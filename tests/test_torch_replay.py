"""The port's article replay on the CPU, against the root ``article_replay.py``.

Checked:

* each option of ``data/synthetic.make_r6d_dataset`` that the replay needs
  (``finger_signal``, ``split_counts``, ``ik_roundtrip=False``,
  ``image_dim``) writes the JAX package's fixture: r6d within 1e-4, xyz
  within 1e-5, everything else equal (the tolerances of
  tests/test_torch_classifier.py::test_synthetic_dataset_matches_jax);
* the replay's helpers give the root's results on the same inputs:
  ``_selection_indices``, ``_build_gt_subset``, ``_build_masked_r6d``,
  ``_fixture_fingerprint``, ``_parse_fingers``, the metrics readers and
  ``_finger_trend_comparison`` (for K > 5 the port correlates over the
  K ≤ 5 prefix and judges monotonicity on the whole series, where the root
  reports neither);
* the port's replay against the root's at ``--scale tiny``, narrow widths,
  dropout 0, from the root's initial weights (handed over through
  ``models/convert``), through all four epochs (0-2 train G and validate,
  3 trains D): at the learning rate 1e-4 of the first configuration its
  whole G train and val series and the inference L1 of every split within
  1e-5 relative of the root's; at the 1e-3 of the second, epoch 0's G
  train loss within 1e-5 of the root's, the whole series within 1e-5 x 10
  of the port's own trainer in float64 from the same weights, and the
  inference L1 within 1e-5 x 10 of the root's (see below); each
  configuration's D epoch, from the root's own state after epoch 2,
  through both trainers within 1e-5; the GT and enhanced classifier val
  accuracies within one val window's share;
* the port alone at ``tiny`` on the CPU with the raw smoke, two fingers,
  the reference-config classifier (at narrow width) and the anomaly
  controls, each configuration's two test GIFs in the report;
  ``--resume`` reuses every stage verbatim, also after the report is
  deleted and after the fixture is wiped and regenerated; the report is
  written with no ``.prior`` or temporary file beside it;
* the unidirectional reference-config stage (``--refcfg_nonbidir_epochs
  1``, the root's ``refcfg_nonbidir_followup.py``) on a resumed replay:
  its key and note in the replay's own report, through its flush, every
  other entry as it was, no file of the repository written, and skipped
  on the next ``--resume``;
* ``--device`` defaults to CUDA and refuses before any work without it.

The comparison's tolerance.  1e-5 relative is the train CLI's
(tests/test_torch_train_cli.py), whose room is for the sign flips of
noise-sized gradients in Adam's first steps: each flipped entry moves by
2 lr, so the room grows with lr.  On this fixture at lr 1e-3 the JAX
package's own first v2+text G step (float32, CPU) puts 21 generator
entries 2 lr from a float64 step of the same state, and the next step's
loss 6.7e-5 from float64's, while the port's step moves none (its loss
1.5e-7 from float64's; ``pytest -s`` prints the three;
``test_the_roots_first_step_at_lr_1e3_leaves_float64`` measures this).  So
past its first epoch the second configuration is held against float64, at
1e-5 x (1e-3 / 1e-4): at epoch 2 the root's G train loss is 4.3e-4 from
float64's and the port's 5.0e-5 (when this was written).

The port's GIFs are rendered from the first 2 frames of each clip (the
renderer wrapped for the whole module): a 192-frame window takes ~40 s on
the CPU.  The renderer itself is held against the JAX package's on whole
clips in tests/test_torch_viz.py.

The D epoch's loss is held from one state, because from the runs' own
states it is ill-conditioned in G's weights: D sees ``calc_motion`` of G's
output, differences of nearly equal frames (a per-channel spread of ~3e-3
against values of ~1), which its train-mode BatchNorm scales back up.  At
lr 1e-4 the G states after epoch 2, whose G losses agree within 2.5e-7
with float64's, give D epoch means 1.1e-3 (port) and 5.4e-4 (root) from
the float64 run's (at lr 1e-3, 1.9e-2 and 6.2e-3); from one state the
port's D epoch is 6e-8 from float64's (when this was written).
"""

import functools
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import article_replay as root_replay
import classifier_main as root_cls_cli
import classifier_mlp_main as root_mlp_cli
import inference as root_inference
import train_gan as root_train_cli
from multimodal_hand_pose_enhancement_for_sign_language_tpu.data import (
    synthetic as j_synthetic,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu.models import (
    registry as j_registry,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu.train import (
    classifier as j_cls,
    data as j_data,
    gan as j_gan,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch import (
    article_replay as t_replay,
    classifier_main as t_cls_cli,
    classifier_mlp_main as t_mlp_cli,
    inference as t_inference,
    train_gan as t_train_cli,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data import (
    synthetic as t_synthetic,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data.io import (
    load_binary,
    save_binary,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models import (
    classifier as t_models,
    convert,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.train import (
    checkpoint as t_ckpt,
    gan as t_gan,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.viz import viz_3d as t_viz

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5  # the train CLI's tolerance at lr 1e-4 (tests/test_torch_train_cli.py)
SIZE = 32  # generator width of the replay comparisons
TINY = ["--scale", "tiny", "--epochs", "4", "--batch_size", "8",
        "--classifier_epochs", "2", "--classifier_batch", "8",
        "--classifier_hidden", "16"]


GIF_FRAMES = 2  # frames of each clip the replay's GIFs are rendered from here


@pytest.fixture(autouse=True, scope="module")
def _short_gifs():
    """The port's renderer on the first GIF_FRAMES frames of each clip."""
    real = t_viz.viz
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_viz, "viz", lambda xyz, **kw: real(
            [np.asarray(c)[:GIF_FRAMES] for c in xyz], **kw))
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The LSTM's CPU path is thousands of tiny ops a step; under the test
    runner's parallel workers OpenMP's waiting threads would spin on the
    shared cores (tests/test_torch_classifier_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (a) the restored fixture options -----------------------------------------

@pytest.mark.parametrize("option", [
    dict(finger_signal=True),
    dict(split_counts={"train": 5, "val": 3, "test": 2}),
    dict(ik_roundtrip=False),
    dict(image_dim=24),
], ids=["finger_signal", "split_counts", "no_ik_roundtrip", "image_dim"])
def test_synthetic_dataset_option_matches_jax(tmp_path, option):
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    kw = dict(n_clips=8, t_range=(40, 140), seed=7, text_dim=384, **option)
    j_synthetic.make_r6d_dataset(a, **kw)
    t_synthetic.make_r6d_dataset(b, device="cpu", **kw)
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for f in sorted(os.listdir(a)):
        ja, tb = load_binary(os.path.join(a, f)), load_binary(os.path.join(b, f))
        assert len(ja) == len(tb), f
        if f.startswith(("r6d_", "xyz_")):
            assert [c.shape for c in ja] == [c.shape for c in tb]
            atol = 1e-4 if f.startswith("r6d_") else 1e-5
            for x, y in zip(ja, tb):
                np.testing.assert_allclose(y, x, atol=atol, err_msg=f)
        else:  # categories, embeddings and image features: numpy's alone
            for x, y in zip(ja, tb):
                np.testing.assert_array_equal(np.asarray(y), np.asarray(x), err_msg=f)
    if "split_counts" in option:
        assert len(load_binary(os.path.join(b, "r6d_test.pkl"))) == 2
    if "image_dim" in option:
        assert load_binary(os.path.join(b, "val_vid_feats.pkl"))[0].shape[1] == 24


# (b) the helpers against the root's ----------------------------------------

def _clips(rng, n, nan_at=()):
    clips = [rng.randn(int(rng.randint(100, 260)), 288).astype(np.float32)
             for _ in range(n)]
    for i in nan_at:
        clips[i][5, 7] = np.nan  # inside the 192-frame window
    return clips


@pytest.mark.parametrize("require_text,with_file", [
    (False, False), (True, False), (False, True)])
def test_selection_indices_match_root(tmp_path, require_text, with_file):
    rng = np.random.RandomState(3)
    data_dir, res_dir = tmp_path / "data", tmp_path / "res"
    data_dir.mkdir()
    res_dir.mkdir()
    for split in ("train", "val"):
        save_binary(_clips(rng, 9, nan_at=(2,)), str(data_dir / f"r6d_{split}.pkl"))
        feats = rng.randn(9, 16).astype(np.float32)
        feats[4, 3] = np.nan
        save_binary(feats, str(data_dir / f"{split}_sentence_embeddings.pkl"))
        save_binary(_clips(rng, 5), str(res_dir / f"r6d_{split}.pkl"))
        if with_file:
            save_binary([0, 3, 5, 6, 8], str(res_dir / f"sel_indices_{split}.pkl"))
    for split in ("train", "val"):
        got = t_replay._selection_indices(str(res_dir), str(data_dir), split,
                                          require_text=require_text)
        want = root_replay._selection_indices(str(res_dir), str(data_dir), split,
                                              require_text=require_text)
        assert list(got) == list(want)
        assert 2 not in got and (not require_text or 4 not in got)


def test_gt_subset_and_masked_r6d_match_root(tmp_path):
    rng = np.random.RandomState(4)
    data_dir = tmp_path / "data"
    data_dir.mkdir()
    for split in ("train", "val"):
        save_binary(_clips(rng, 7), str(data_dir / f"r6d_{split}.pkl"))
    sel = {"train": [0, 2, 3, 6], "val": [1, 5]}
    t_replay._build_gt_subset(str(data_dir), str(tmp_path / "t_gt"), sel)
    root_replay._build_gt_subset(str(data_dir), str(tmp_path / "j_gt"), sel)
    arm, hand = t_replay.win_lib.pipeline_column_slices("arm2wh")
    for cols, tag in ((hand, "arms"), (arm, "hands")):
        t_replay._build_masked_r6d(str(tmp_path / "t_gt"), str(tmp_path / f"t_{tag}"), cols)
        root_replay._build_masked_r6d(str(tmp_path / "j_gt"), str(tmp_path / f"j_{tag}"),
                                      cols)
    for d in ("gt", "arms", "hands"):
        for split in ("train", "val"):
            got = load_binary(str(tmp_path / f"t_{d}" / f"r6d_{split}.pkl"))
            want = load_binary(str(tmp_path / f"j_{d}" / f"r6d_{split}.pkl"))
            assert len(got) == len(want) == len(sel[split])
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    masked = load_binary(str(tmp_path / "t_hands" / "r6d_val.pkl"))[0]
    assert not masked[:, arm].any() and masked[:, hand].any()


def test_fixture_fingerprint_matches_root(tmp_path):
    t_synthetic.make_r6d_dataset(str(tmp_path), n_clips=4, t_range=(40, 60), seed=2,
                                 save_image_feats=False, device="cpu")
    (tmp_path / "fixture_meta.json").write_text("{}")  # not a pickle: not hashed
    fp = t_replay._fixture_fingerprint(str(tmp_path))
    assert fp == root_replay._fixture_fingerprint(str(tmp_path))
    save_binary([1], str(tmp_path / "categs_val.pkl"))
    assert t_replay._fixture_fingerprint(str(tmp_path)) != fp


@pytest.mark.parametrize("spec", ["1,2,5", "1..5", "3..3", "2,", "4"])
def test_parse_fingers_matches_root(spec):
    assert t_replay._parse_fingers(spec) == root_replay._parse_fingers(spec)


def test_constants_match_root():
    assert t_replay.ARTICLE_REFERENCE == root_replay.ARTICLE_REFERENCE
    assert t_replay.SCALES == root_replay.SCALES
    assert t_replay.CONFIGS == root_replay.CONFIGS
    # the root's --reference_classifier stage (article_replay.py:1097-1101)
    assert t_replay.REFERENCE_CLASSIFIER == dict(
        classifier_hidden=1024, classifier_layers=10, classifier_bidir=True)


def test_metrics_readers_match_root(tmp_path):
    p = tmp_path / "metrics.jsonl"
    vals = [2.0, 1.5, 1.75, 1.25, 1.5]  # best at epoch 3
    recs = ([{"event": "config", "epochs": 5}]
            + [r for e, v in enumerate(vals)
               for r in ({"epoch": e, "loss_train_gen": v + 1}, {"loss_val_gen": v})]
            + [{"epoch": 0, "loss_train_gen": 9.0}, {"loss_val_gen": 9.5},
               {"epoch": 1, "loss_train_disc": 1.0}])
    for cut in (len(recs), 11):  # a restarted run, and one complete run
        with open(p, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in recs[:cut])
        for name in ("_metrics_best_val", "_metrics_best_val_epoch",
                     "_metrics_epochs_done"):
            assert getattr(t_replay, name)(p) == getattr(root_replay, name)(p), name
    assert t_replay._metrics_epochs_done(p) == 5


def _trend(val, test):
    return {str(k): {"inference": {"L1": {"val": v, "test": t}}}
            for k, (v, t) in enumerate(zip(val, test), start=1)}


@pytest.mark.parametrize("n", [2, 3, 5])
def test_finger_trend_comparison_matches_root_up_to_k5(n):
    art = root_replay.ARTICLE_REFERENCE["table2_finger_trend_L1"]
    rng = np.random.RandomState(n)
    cases = [_trend(art["val"][:n], art["test"][:n]),
             _trend([0.28] * n, [0.28] * n),
             _trend(list(rng.rand(n)), list(rng.rand(n)))]
    cases[0][str(n + 1)] = {"train": {"best_val": 0.5}}  # no inference: skipped
    for trend in cases:
        assert t_replay._finger_trend_comparison(trend) == \
            root_replay._finger_trend_comparison(trend)


def test_finger_trend_beyond_k5_uses_the_prefix():
    """K = 1..7: the root reports neither correlation nor monotonicity when
    the series outruns the article's five points; the port correlates over
    the K ≤ 5 prefix and judges monotonicity on all seven."""
    art = root_replay.ARTICLE_REFERENCE["table2_finger_trend_L1"]
    val = art["val"] + [0.45, 0.47]
    test = art["test"] + [0.44, 0.43]  # falls at K=7
    got = t_replay._finger_trend_comparison(_trend(val, test))
    prefix = t_replay._finger_trend_comparison(_trend(art["val"], art["test"]))
    assert got["K"] == list(range(1, 8))
    for split in ("val", "test"):
        assert got[split]["article_L1"] == art[split]
        assert got[split]["pearson_r"] == pytest.approx(1.0)
        assert got[split]["pearson_r"] == prefix[split]["pearson_r"]
        assert got[split]["spearman_r"] == prefix[split]["spearman_r"]
    assert got["val"]["strictly_monotone"] is True
    assert got["test"]["strictly_monotone"] is False
    root = root_replay._finger_trend_comparison(_trend(val, test))
    assert "pearson_r" not in root["val"] and "strictly_monotone" not in root["val"]


# (c) the port's replay against the root's ---------------------------------

def _with_defaults(cli, **defaults):
    build = cli.build_parser

    def built():
        p = build()
        p.set_defaults(**defaults)
        return p

    return built


def _in_float64(tr):
    """A port GanTrainer whose models and steps run in float64."""
    for m in (tr.generator, tr.discriminator, tr.adaptive):
        if m is not None:
            m.to(torch.float64)
    for kind in ("g_step", "d_step", "val_step"):
        step = getattr(tr, kind)
        setattr(tr, kind, lambda x, y, f=None, step=step: step(
            x.double(), y.double(), None if f is None else f.double()))
    return tr


def _narrow_generators(mp):
    """The port's train and inference CLIs at generator width SIZE: the
    replay leaves them at their own default of 256."""
    mp.setattr(t_train_cli, "build_parser", _with_defaults(t_train_cli, default_size=SIZE))
    mp.setattr(t_inference, "build_parser", _with_defaults(t_inference, default_size=SIZE))


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The root replay, then the port's, each in a directory of its own,
    from the same initial weights, dropout 0.  The port resumes from a copy
    of the root's fixture (its own fixture is within 1e-4 of it, as the
    cases above hold), so that the comparison holds the chain of stages."""
    base = tmp_path_factory.mktemp("replay_vs_root")
    gan_init, cls_init = {}, []
    gan_init_state = j_gan.GanTrainer.init_state
    cls_init_state = j_cls.ClassifierTrainer.init_state

    def record_gan(self, rng=None):
        state = gan_init_state(self, rng)
        gan_init[(self.cfg.model, self.cfg.pipeline)] = jax.tree.map(
            np.asarray, {k: v for k, v in state.items() if k != "rng"})
        return state

    def record_cls(self, rng, sample_x):
        params, opt_state = cls_init_state(self, rng, sample_x)
        cls_init.append(jax.tree.map(np.asarray, params))
        return params, opt_state

    def bridged_trainer(cfg, device):
        tr = t_gan.GanTrainer(cfg, device=device)
        init = gan_init[(cfg.model, cfg.pipeline)]
        tr.generator.load_state_dict(convert.generator_state_dict(
            {"params": init["g_params"], "batch_stats": init["g_stats"]}), strict=True)
        tr.discriminator.load_state_dict(convert.discriminator_state_dict(
            {"params": init["d_params"], "batch_stats": init["d_stats"]}), strict=True)
        return tr

    def bridged_classifier(kind, **kw):
        net = t_models.build_classifier(kind, **kw)
        to_sd = (convert.classifier_state_dict if kind == "lstm"
                 else convert.sentence_classifier_state_dict)
        net.load_state_dict(to_sd(cls_init.pop(0)), strict=True)
        return net

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        os.makedirs(base / "jax")
        mp.chdir(base / "jax")  # the CLIs write root.pkl, GT_predY.csv here
        mp.setattr(j_gan.GanTrainer, "init_state", record_gan)
        mp.setattr(j_cls.ClassifierTrainer, "init_state", record_cls)
        mp.setattr(root_train_cli, "GanConfig", lambda **kw: j_gan.GanConfig(
            **{**kw, "dropout_rate": 0.0, "default_size": SIZE}))
        mp.setattr(root_inference.registry, "build_generator",
                   functools.partial(j_registry.build_generator, default_size=SIZE))
        mp.setattr(root_inference.viz_3d, "viz", lambda *a, **k: [])  # tests/test_torch_viz.py
        mp.setattr(root_cls_cli, "build_parser",
                   _with_defaults(root_cls_cli, dropout=0.0))
        argv = TINY + ["--skip_raw_smoke",
                       "--work_dir", str(base / "jax" / "work"),
                       "--out", str(base / "jax" / "AR.json")]
        out["jax"] = root_replay.main(root_replay.build_parser().parse_args(argv))

        shutil.copytree(base / "jax" / "work" / "video_data",
                        base / "port" / "work" / "video_data")
        mp.chdir(base / "port")
        mp.setattr(t_train_cli, "GanConfig", lambda **kw: t_gan.GanConfig(
            **{**kw, "dropout_rate": 0.0}))
        mp.setattr(t_train_cli, "GanTrainer", bridged_trainer)
        mp.setattr(t_cls_cli, "build_classifier", bridged_classifier)
        mp.setattr(t_mlp_cli, "build_classifier", bridged_classifier)
        mp.setattr(t_cls_cli, "build_parser", _with_defaults(t_cls_cli, dropout=0.0))
        _narrow_generators(mp)
        argv = TINY + ["--skip_raw_smoke",
                       "--work_dir", str(base / "port" / "work"),
                       "--out", str(base / "port" / "AR.json"), "--device", "cpu",
                       "--resume"]
        out["port"] = t_replay.main(t_replay.build_parser().parse_args(argv))

        # the port's training stage again, its steps in float64 from the
        # same weights: the reference past the root's own float32 flips
        mp.setattr(t_train_cli, "GanTrainer",
                   lambda cfg, device: _in_float64(bridged_trainer(cfg, device)))
        args = t_replay.build_parser().parse_args(argv)
        for cfg in t_replay.CONFIGS:
            t_replay.stage_train(cfg, str(base / "port" / "work" / "video_data"),
                                 str(base / "float64" / "models"), args)
    assert not cls_init  # every recorded classifier was handed over
    out["dirs"] = {k: base / k / "work" for k in ("jax", "port")}
    out["dirs"]["float64"] = base / "float64"
    return out


def _config(name):
    (cfg,) = [c for c in root_replay.CONFIGS if c["name"] == name]
    return cfg


def _rtol(name):
    """LOSS_RTOL, scaled by the configuration's learning rate over 1e-4."""
    return LOSS_RTOL * _config(name)["learning_rate"] / 1e-4


def _series(work, name, key):
    with open(os.path.join(work, "models", f"metrics_{name}.jsonl")) as f:
        return [r[key] for r in map(json.loads, f) if key in r]


@pytest.mark.parametrize("name", [c["name"] for c in root_replay.CONFIGS])
def test_replay_training_follows_the_root(both, name):
    """Epochs 0-2 train G and validate, epoch 3 trains D.  At lr 1e-4 the
    whole G series within 1e-5 of the root's; at lr 1e-3 epoch 0's G train
    loss within 1e-5 of the root's and the whole series within the scaled
    tolerance of float64's (the module docstring says why)."""
    at_1e4 = _config(name)["learning_rate"] <= 1e-4
    series = {}
    for key in ("loss_train_gen", "loss_val_gen", "loss_train_disc"):
        series[key] = {k: _series(both["dirs"][k], name, key)
                       for k in ("port", "jax", "float64")}
        got, want, f64 = series[key]["port"], series[key]["jax"], series[key]["float64"]
        assert len(got) == len(want) == len(f64) == (1 if key == "loss_train_disc" else 3), key
        print(f"{name} {key}: port {got}, root {want}, float64 {f64}")
        if key == "loss_train_disc":  # held from one state below
            continue
        if at_1e4:
            np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, err_msg=f"{name} {key}")
        else:
            np.testing.assert_allclose(got, f64, rtol=_rtol(name), err_msg=f"{name} {key}")
    train = series["loss_train_gen"]
    np.testing.assert_allclose(train["port"][0], train["jax"][0], rtol=LOSS_RTOL)
    best = both["port"]["configs"][name]["train"]["best_val"]
    assert best == pytest.approx(min(series["loss_val_gen"]["port"]), rel=1e-7)
    np.testing.assert_allclose(best, both["jax"]["configs"][name]["train"]["best_val"],
                               rtol=LOSS_RTOL if at_1e4 else _rtol(name))


@pytest.mark.parametrize("name", [c["name"] for c in root_replay.CONFIGS])
def test_replay_d_epoch_follows_the_root_from_one_state(both, name, tmp_path):
    """The D epoch of the replay (epoch 3), from the root's own state after
    epoch 2 (its best checkpoint, which the replay wrote), through the JAX
    package's trainer and the port's on the same batches: the port's mean
    loss within 1e-5 of its float64 trainer's, and within 1e-5 of the
    root's unless the root's is more than 1e-5 from float64's.  At lr 1e-4
    it is: the root's first D step puts 51 of the 121,681 entries of D more
    than lr from a float64 step (Adam's sign of a noise-sized gradient), the
    port's none, and the root's epoch mean lands 2.6e-4 from float64's
    (when this was written)."""
    cfg = _config(name)
    ck = t_ckpt.load_jax_pickle(str(both["dirs"]["jax"] / "models" / f"{name}_checkpoint.pkl"))
    assert ck["epoch"] == 2  # the best val epoch, the last before the D epoch
    data = j_data.load_data(str(both["dirs"]["jax"] / "video_data"), cfg["pipeline"],
                            str(tmp_path), "probe", np.random.RandomState(23456),
                            require_text=cfg["require_text"])
    X, Y, F = data["train_X"], data["train_Y"], data["train_feats"]
    kw = dict(model=cfg["model"], pipeline=cfg["pipeline"], feature_in_dim=X.shape[-1],
              feature_out_dim=Y.shape[-1], batch_size=8, learning_rate=cfg["learning_rate"],
              loss=cfg["loss"], require_text=cfg["require_text"], default_size=SIZE,
              window_t=X.shape[1], dropout_rate=0.0)
    jt = j_gan.GanTrainer(j_gan.GanConfig(**kw))
    state = jt.init_state()  # the D optimizer's fresh state: D has not trained yet
    for k in ("g_params", "g_stats", "d_params", "d_stats"):
        state[k] = jax.tree.map(jnp.asarray, ck["state"][k])
    _, want = jt.run_epoch(state, X, Y, F, "d", 8)
    losses = []
    for to_dtype in (lambda tr: tr, _in_float64):
        tr = t_gan.GanTrainer(t_gan.GanConfig(**kw), device="cpu")
        tr.generator.load_state_dict(convert.generator_state_dict(
            {"params": ck["state"]["g_params"], "batch_stats": ck["state"]["g_stats"]}),
            strict=True)
        tr.discriminator.load_state_dict(convert.discriminator_state_dict(
            {"params": ck["state"]["d_params"], "batch_stats": ck["state"]["d_stats"]}),
            strict=True)
        losses.append(to_dtype(tr).run_epoch(X, Y, "d", 8, F))
    got, f64 = losses
    assert X.shape[0] // 8 >= 3  # the epoch takes several D steps
    root_off = abs(want / f64 - 1)
    print(f"{name} D epoch from one state: port {got}, root {want}, float64 {f64}")
    np.testing.assert_allclose(got, f64, rtol=LOSS_RTOL)
    assert abs(got / want - 1) <= LOSS_RTOL or root_off > LOSS_RTOL, (got, want, f64)


@pytest.mark.parametrize("name", [c["name"] for c in root_replay.CONFIGS])
def test_replay_inference_follows_the_root(both, name):
    got = both["port"]["configs"][name]["inference"]["L1"]
    want = both["jax"]["configs"][name]["inference"]["L1"]
    assert sorted(got) == sorted(want) == ["test", "train", "val"]
    for split in want:
        np.testing.assert_allclose(got[split], want[split], rtol=_rtol(name), err_msg=split)


def test_replay_classifiers_follow_the_root(both):
    got, want = both["port"]["classifier"], both["jax"]["classifier"]
    assert set(got) == set(want) == {"ground_truth_r6d", "enhanced_r6d", "text_mlp",
                                     "windows"}
    assert got["windows"] == want["windows"]
    share = 1.0 / want["windows"]["val"]  # one val window
    for key in ("ground_truth_r6d", "enhanced_r6d", "text_mlp"):
        assert abs(got[key]["best_val_acc"] - want[key]["best_val_acc"]) <= share + 1e-9, key


def test_replay_report_has_the_roots_keys(both):
    got, want = both["port"], both["jax"]
    assert set(got) == set(want)
    for key in ("fixture_notes", "article_reference"):
        assert set(got[key]) == set(want[key]), key
    # the port resumed the root's fixture: the root's resumed entry's keys
    assert set(got["fixture"]) == set(want["fixture"]) - {"wall_s"} | {"resumed"}
    for name, entry in want["configs"].items():
        assert set(got["configs"][name]) == set(entry)
        assert set(got["configs"][name]["train"]) == set(entry["train"])
    assert got["fixture"]["counts"] == want["fixture"]["counts"]


def test_the_roots_first_step_at_lr_1e3_leaves_float64(both, tmp_path):
    """The measurement behind the second configuration's tolerance: on the
    replay's own first batch, the JAX package's float32 G step at lr 1e-3
    moves some generator entries 2 lr from a float64 step of the same state
    (Adam's sign of a noise-sized gradient), the port's float32 step moves
    none, and the next step's loss is off float64's by more than 1e-5 in the
    JAX package and less in the port (both within the scaled tolerance)."""
    cfg = root_replay.CONFIGS[1]
    lr = cfg["learning_rate"]
    data = j_data.load_data(str(both["dirs"]["jax"] / "video_data"), cfg["pipeline"],
                            str(tmp_path), "probe", np.random.RandomState(23456),
                            require_text=True)
    X, Y, F = data["train_X"], data["train_Y"], data["train_feats"]
    kw = dict(model=cfg["model"], pipeline=cfg["pipeline"], feature_in_dim=X.shape[-1],
              feature_out_dim=Y.shape[-1], batch_size=8, learning_rate=lr,
              loss=cfg["loss"], require_text=True, default_size=SIZE,
              window_t=X.shape[1], dropout_rate=0.0)
    jt = j_gan.GanTrainer(j_gan.GanConfig(**kw))
    state = jt.init_state()
    s0 = jax.tree.map(np.asarray, {k: v for k, v in state.items() if k != "rng"})
    ports = []
    for dtype in (torch.float32, torch.float64):
        tr = t_gan.GanTrainer(t_gan.GanConfig(**kw), device="cpu")
        tr.generator.load_state_dict(convert.generator_state_dict(
            {"params": s0["g_params"], "batch_stats": s0["g_stats"]}), strict=True)
        tr.discriminator.load_state_dict(convert.discriminator_state_dict(
            {"params": s0["d_params"], "batch_stats": s0["d_stats"]}), strict=True)
        for m in (tr.generator, tr.discriminator, tr.adaptive):
            m.to(dtype)
        tr.g_opt = type(tr.g_opt)(tr.generator.parameters(), **tr.g_opt.defaults)
        ports.append((tr, dtype))
    losses = []
    for b in range(2):
        x, y, f = X[8 * b: 8 * b + 8], Y[8 * b: 8 * b + 8], F[8 * b: 8 * b + 8]
        state, j_loss = jt._g_step(state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(f))
        losses.append([float(j_loss)] + [
            float(tr.g_step(*(torch.from_numpy(a).to(dt) for a in (x, y, f))))
            for tr, dt in ports])
        if b == 0:
            want = ports[1][0].generator.state_dict()
            got_jax = convert.generator_state_dict(
                {"params": jax.tree.map(np.asarray, state["g_params"]),
                 "batch_stats": jax.tree.map(np.asarray, state["g_stats"])})
            got_port = ports[0][0].generator.state_dict()
            keys = [k for k in got_jax if "num_batches" not in k]
            flips = sum(int(((got_jax[k].double() - want[k]).abs() > lr).sum()) for k in keys)
            port_off = max(float((got_port[k].double() - want[k]).abs().max()) for k in keys)
            assert flips > 0 and port_off < lr, (flips, port_off)
    j_loss, p_loss, f64_loss = losses[1]
    j_rel, p_rel = abs(j_loss / f64_loss - 1), abs(p_loss / f64_loss - 1)
    print(f"entries 2 lr off float64 {flips}; next loss off float64: JAX {j_rel:.3e}, "
          f"port {p_rel:.3e}")
    assert p_rel <= LOSS_RTOL < j_rel <= _rtol(cfg["name"]), (j_rel, p_rel)


# (d) the port alone: every stage and --resume ------------------------------

ALONE = TINY + ["--device", "cpu", "--fingers", "1,2", "--finger_epochs", "2",
                "--reference_classifier", "--reference_classifier_epochs", "1",
                "--anomaly_controls"]


def _alone_args(d):
    return t_replay.build_parser().parse_args(
        ALONE + ["--work_dir", str(d / "work"), "--out", str(d / "AR.json")])


@pytest.fixture(scope="module")
def narrow():
    """Generators SIZE wide, and the reference-config classifier at a
    narrow width: 1024 x 10 x bidir takes minutes a step on a CPU (the full
    widths run on the card in chip_smoke.py)."""
    with pytest.MonkeyPatch.context() as mp:
        _narrow_generators(mp)
        mp.setattr(t_replay, "REFERENCE_CLASSIFIER", dict(
            classifier_hidden=24, classifier_layers=3, classifier_bidir=True))
        yield


@pytest.fixture(scope="module")
def alone(tmp_path_factory, narrow):
    d = tmp_path_factory.mktemp("replay_alone")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(d)
        report = t_replay.main(_alone_args(d))
    return d, report


def test_replay_alone_runs_every_stage(alone):
    d, report = alone
    on_disk = json.loads((d / "AR.json").read_text())
    assert on_disk == json.loads(json.dumps(report))
    names = [c["name"] for c in t_replay.CONFIGS] + [
        f"arm_wh2finger{k}_v2_text_RobustLoss_trend" for k in (1, 2)]
    assert sorted(os.listdir(d)) == sorted(
        ["AR.json", "GT_predY.csv", "bone_len.pkl", "root.pkl", "work"]
        + [f"viz_results_{n}_test" for n in names])  # no .prior, no .tmp
    for entry in (*on_disk["configs"].values(), *on_disk["finger_trend"].values()):
        gifs = entry["inference"]["gifs"]
        assert list(gifs) == ["test"]  # the test split alone, as the root
        assert [os.path.basename(p) for p in gifs["test"]] == ["0.gif", "1.gif"]
        for p in gifs["test"]:
            with Image.open(p) as im:
                assert im.n_frames == GIF_FRAMES
    assert on_disk["completed"] is True and on_disk["core_completed"] is True
    raw = on_disk["raw_pipeline_smoke"]
    assert raw["wall_s"] > 0 and "r6d_train.pkl" in raw["artifacts"]
    for entry in on_disk["configs"].values():
        for split in ("train", "val", "test"):
            assert np.isfinite(entry["inference"]["L1"][split])
        assert entry["train"]["best_val_epoch"] is not None
    cls = on_disk["classifier"]
    assert set(cls) == {"ground_truth_r6d", "enhanced_r6d", "enhanced_r6d_reference_config",
                        "text_mlp", "windows", "anomaly_controls"}
    assert set(cls["anomaly_controls"]) == {"gt_arms_only", "gt_hands_only",
                                            "enhanced_hands_only", "gt_arms_only_long",
                                            "explanation"}
    for key in ("ground_truth_r6d", "enhanced_r6d", "enhanced_r6d_reference_config",
                "text_mlp"):
        assert 0.0 <= cls[key]["best_val_acc"] <= 1.0
    refcfg = cls["enhanced_r6d_reference_config"]
    assert (refcfg["hidden"], refcfg["layers"], refcfg["epochs"]) == (24, 3, 1)
    assert set(on_disk["finger_trend"]) == {"1", "2"}
    for entry in on_disk["finger_trend"].values():
        for split in ("val", "test"):
            assert np.isfinite(entry["inference"]["L1"][split])
    assert on_disk["finger_trend_vs_article"]["val"]["article_L1"] == [0.320, 0.331]
    assert "FLAT" in on_disk["fixture_notes"]["fingers"]


def _copy(alone, dst):
    d, _ = alone
    shutil.copytree(d / "work", dst / "work")
    shutil.copyfile(d / "AR.json", dst / "AR.json")
    return json.loads((d / "AR.json").read_text())


STAGES = ("raw_pipeline_smoke", "configs", "classifier", "finger_trend",
          "finger_trend_vs_article")


def test_resume_reuses_every_stage(alone, tmp_path, monkeypatch, narrow):
    first = _copy(alone, tmp_path)
    monkeypatch.chdir(tmp_path)
    args = _alone_args(tmp_path)
    args.resume = True
    for stage in ("stage_train", "stage_classifier", "stage_raw_smoke",
                  "stage_mlp_classifier"):
        monkeypatch.setattr(t_replay, stage, None)  # any call would raise
    resumed = t_replay.main(args)
    assert resumed["completed"] is True
    assert resumed["fixture"]["resumed"] is True
    for key in STAGES:
        assert resumed[key] == first[key], key
    assert not os.path.exists(tmp_path / "AR.json.prior")


def test_resume_after_the_report_is_deleted(alone, tmp_path, monkeypatch):
    first = _copy(alone, tmp_path)
    os.remove(tmp_path / "AR.json")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(t_replay, "stage_train", None)
    args = _alone_args(tmp_path)
    args.resume, args.skip_classifier, args.fingers = True, True, ""
    recovered = t_replay.main(args)
    assert recovered["fixture"]["resumed"] is True
    assert recovered["raw_pipeline_smoke"]["resumed"] is True
    for name, entry in recovered["configs"].items():
        assert entry["train"]["resumed"] is True
        assert entry["train"]["best_val"] == first["configs"][name]["train"]["best_val"]
        # inference ran again from the recovered checkpoints, to the bit
        assert entry["inference"]["L1"] == first["configs"][name]["inference"]["L1"]


def test_resume_after_the_fixture_is_regenerated(alone, tmp_path, monkeypatch,
                                                 narrow):
    first = _copy(alone, tmp_path)
    shutil.rmtree(tmp_path / "work" / "video_data")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(t_replay, "stage_train", None)
    args = _alone_args(tmp_path)
    args.resume = True
    second = t_replay.main(args)
    assert "resumed" not in second["fixture"]  # made again, the same bytes
    assert second["fixture"]["fingerprint"] == first["fixture"]["fingerprint"]
    for key in ("configs", "classifier", "finger_trend"):
        assert second[key] == first[key], key

    # another fixture (the signal one) invalidates every stage: training
    # runs again, and no prior entry survives into the report
    args.signal_fixture, args.skip_classifier, args.fingers = True, True, ""
    trained = []
    monkeypatch.setattr(t_replay, "stage_train",
                        lambda cfg, *a: trained.append(cfg["name"]) or {"best_val": 0.0})
    monkeypatch.setattr(t_replay, "stage_infer", lambda *a, **k: {"L1": {}, "wall_s": {}})
    third = t_replay.main(args)
    assert trained == [c["name"] for c in t_replay.CONFIGS]
    assert "classifier" not in third and "finger_trend" not in third
    assert third["fixture"]["fingerprint"] != first["fixture"]["fingerprint"]


def test_refcfg_nonbidir_stage_writes_into_the_replays_report(alone, tmp_path, monkeypatch,
                                                             narrow):
    first = _copy(alone, tmp_path)
    monkeypatch.chdir(tmp_path)
    repo_files = {p: p.stat().st_mtime_ns for p in ROOT.glob("ARTICLE_REPLAY*.json")}
    for stage in ("stage_train", "stage_raw_smoke", "stage_mlp_classifier"):
        monkeypatch.setattr(t_replay, stage, None)  # any call would raise
    ran = []
    real = t_replay.stage_classifier

    def spy(tag, r6d_dir, data_dir, model_dir, args, sel=None):
        ran.append((tag, args.classifier_bidir, args.classifier_epochs, r6d_dir))
        return real(tag, r6d_dir, data_dir, model_dir, args, sel=sel)

    monkeypatch.setattr(t_replay, "stage_classifier", spy)
    args = _alone_args(tmp_path)
    args.resume, args.refcfg_nonbidir_epochs = True, 1
    report = t_replay.main(args)
    res_dir = str(tmp_path / "work" / f"results_{t_replay.CONFIGS[0]['name']}")
    assert ran == [("enhanced_refcfg_nonbidir", False, 1, res_dir)]
    on_disk = json.loads((tmp_path / "AR.json").read_text())
    assert on_disk == json.loads(json.dumps(report))
    cls = on_disk["classifier"]
    uni = cls["enhanced_r6d_reference_config_nonbidir"]
    assert (uni["hidden"], uni["layers"], uni["epochs"], uni["bidir"]) == (24, 3, 1, False)
    assert 0.0 <= uni["best_val_acc"] <= 1.0 and uni["wall_s"] > 0
    assert f"{uni['best_val_acc']:.4f}" in cls["reference_config_note"]
    assert "unidirectional" in cls["reference_config_note"]
    assert {k: v for k, v in cls.items() if k not in (
        "enhanced_r6d_reference_config_nonbidir", "reference_config_note")} == first["classifier"]
    for key in STAGES:
        if key != "classifier":
            assert on_disk[key] == first[key], key
    assert not any(n.endswith((".tmp", ".prior")) for n in os.listdir(tmp_path))
    assert {p: p.stat().st_mtime_ns for p in ROOT.glob("ARTICLE_REPLAY*.json")} == repo_files

    monkeypatch.setattr(t_replay, "stage_classifier", None)  # resumed: skipped
    again = t_replay.main(args)
    assert again["classifier"] == cls


# (e) the device ------------------------------------------------------------

def test_replay_defaults_to_cuda(tmp_path):
    args = t_replay.build_parser().parse_args(
        ["--scale", "tiny", "--work_dir", str(tmp_path / "work"),
         "--out", str(tmp_path / "AR.json")])
    assert args.device == "cuda"
    # the port's report never lands on a report of the JAX package
    defaults = t_replay.build_parser().parse_args([])
    assert (defaults.out, defaults.work_dir) == ("ARTICLE_REPLAY_torch.json",
                                                 "article_replay_work_torch")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_replay.main(args)
    assert not os.listdir(tmp_path)  # refused before any work


# (f) the report write ------------------------------------------------------

def test_flush_report_is_atomic_and_leaves_no_backup(tmp_path, monkeypatch):
    out = str(tmp_path / "AR.json")
    t_replay._flush_report({"a": 1}, out)
    assert json.loads(open(out).read()) == {"a": 1}

    def torn(obj, f, **kw):
        f.write('{"a": ')
        raise OSError("disk full")

    monkeypatch.setattr(t_replay.json, "dump", torn)
    with pytest.raises(OSError):
        t_replay._flush_report({"a": 2}, out)
    assert json.loads(open(out).read()) == {"a": 1}  # the last whole report
    assert sorted(os.listdir(tmp_path)) == ["AR.json", "AR.json.tmp"]
    monkeypatch.undo()
    t_replay._flush_report({"a": 3}, out)
    assert sorted(os.listdir(tmp_path)) == ["AR.json"]
