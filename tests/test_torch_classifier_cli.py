"""The port's classifier CLIs on the CPU, against the root CLIs.

One synthetic dataset (the port's ``data/synthetic``, learnable categories,
384-wide sentence embeddings) serves both packages.  The root
``classifier_main.main`` / ``classifier_mlp_main.main`` run first; their
initial weights are recorded and handed to the port's CLIs through the
weights bridge (``models/convert``), dropout 0.  Per-epoch train and val
losses are held at 1e-5 relative (the reference's one-step tolerance, as
for the GAN CLI in tests/test_torch_train_cli.py), val accuracies exactly,
with and without ``--epoch_scan``.  Also: the contract files (the
best-val-accuracy ``.pth``, which loads strictly, and ``GT_predY.csv``),
``--bidir`` parsing, and ``--device`` defaulting to CUDA.
"""

import csv
import json
import os

import numpy as np
import pytest
import torch

import jax

import classifier_main as root_cli
import classifier_mlp_main as root_mlp_cli
from multimodal_hand_pose_enhancement_for_sign_language_tpu.train import (
    classifier as j_cls,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch import (
    classifier_main as t_cli,
    classifier_mlp_main as t_mlp_cli,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data import synthetic
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models import (
    classifier as t_models,
    convert,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.train import (
    checkpoint as t_ckpt,
)

LOSS_RTOL = 1e-5
EPOCHS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The LSTM's CPU path is thousands of tiny ops a step.  Under the test
    runner's parallel workers, OpenMP's waiting threads spin on the shared
    cores and slow such a step a hundredfold, so these tests run torch on
    one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cls_cli") / "video_data")
    synthetic.make_r6d_dataset(d, n_clips=16, t_range=(100, 230), seed=5, text_dim=384,
                               save_image_feats=False, categ_signal=True, device="cpu")
    return d


def _lstm_args(cli, data_dir, models_dir, **over):
    args = cli.build_parser().parse_args([])
    args.data_dir = data_dir
    args.models_dir = models_dir
    args.num_epochs = EPOCHS
    args.batch_size = 4
    args.hidden_size = 16
    args.num_layers = 2
    args.bidir = True
    args.dropout = 0.0
    args.log_step = 1
    for k, v in over.items():
        setattr(args, k, v)
    return args


def _mlp_args(cli, data_dir, models_dir, **over):
    args = cli.build_parser().parse_args([])
    args.data_dir = data_dir
    args.models_dir = models_dir
    args.num_epochs = EPOCHS
    args.batch_size = 4
    args.learning_rate = 1e-3
    args.log_step = 1
    for k, v in over.items():
        setattr(args, k, v)
    return args


def _metrics(models_dir):
    (name,) = [f for f in os.listdir(models_dir) if f.startswith("metrics_")]
    with open(os.path.join(models_dir, name)) as f:
        return [json.loads(line) for line in f]


def _record_jax_init(monkeypatch):
    captured = {}
    init_state = j_cls.ClassifierTrainer.init_state

    def recording(self, rng, sample_x):
        params, opt_state = init_state(self, rng, sample_x)
        captured["params"] = jax.tree.map(np.asarray, params)
        return params, opt_state

    monkeypatch.setattr(j_cls.ClassifierTrainer, "init_state", recording)
    return captured


def _hand_over(monkeypatch, cli, captured, to_state_dict):
    """Make the port CLI's ``build_classifier`` load the recorded weights."""
    build = t_models.build_classifier

    def bridged(kind, **kw):
        net = build(kind, **kw)
        net.load_state_dict(to_state_dict(captured["params"]), strict=True)
        return net

    monkeypatch.setattr(cli, "build_classifier", bridged)


def _assert_same_epochs(got, want):
    assert len(got) == len(want) == EPOCHS
    for g, w in zip(got, want):
        for key in ("loss_train", "loss_val"):
            np.testing.assert_allclose(g[key], w[key], rtol=LOSS_RTOL, err_msg=key)
        assert g["acc_val"] == w["acc_val"]
        assert g["acc_train"] == w["acc_train"]


@pytest.mark.parametrize("epoch_scan", [False, True], ids=["host", "resident"])
def test_lstm_cli_follows_the_root_cli(data_dir, tmp_path, monkeypatch, epoch_scan):
    monkeypatch.chdir(tmp_path)
    captured = _record_jax_init(monkeypatch)
    j_args = _lstm_args(root_cli, data_dir, str(tmp_path / "jax"), epoch_scan=epoch_scan)
    want_acc = root_cli.main(j_args)

    _hand_over(monkeypatch, t_cli, captured, convert.classifier_state_dict)
    t_args = _lstm_args(t_cli, data_dir, str(tmp_path / "port"), device="cpu",
                        epoch_scan=epoch_scan)
    got_acc = t_cli.main(t_args)
    assert got_acc == want_acc
    assert t_args.exp_name == j_args.exp_name
    _assert_same_epochs(_metrics(t_args.models_dir), _metrics(j_args.models_dir))


def test_mlp_cli_follows_the_root_cli(data_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    captured = _record_jax_init(monkeypatch)
    want_acc = root_mlp_cli.main(_mlp_args(root_mlp_cli, data_dir, str(tmp_path / "jax")))

    _hand_over(monkeypatch, t_mlp_cli, captured, convert.sentence_classifier_state_dict)
    got_acc = t_mlp_cli.main(_mlp_args(t_mlp_cli, data_dir, str(tmp_path / "port"),
                                       device="cpu"))
    assert got_acc == want_acc
    _assert_same_epochs(_metrics(str(tmp_path / "port")), _metrics(str(tmp_path / "jax")))


def test_lstm_cli_writes_its_contract_files(data_dir, tmp_path, monkeypatch):
    """With dropout (the CLI default 0.1) and NAdam: finite losses, the
    best-val checkpoint loading strictly into a fresh model, and the CSV of
    the best epoch's val labels and predictions."""
    monkeypatch.chdir(tmp_path)
    args = _lstm_args(t_cli, data_dir, str(tmp_path / "models"), device="cpu",
                      dropout=0.1, optimizer="NAdam", learning_rate=3e-3)
    best = t_cli.main(args)
    rows = _metrics(args.models_dir)
    assert all(np.isfinite(r["loss_train"]) and np.isfinite(r["loss_val"]) for r in rows)
    assert best == max(r["acc_val"] for r in rows) > 0
    ckpt = os.path.join(args.models_dir, f"{args.exp_name}_checkpoint.pth")
    payload = t_ckpt.load_checkpoint(ckpt)
    assert sorted(payload) == ["epoch", "optimizer", "state_dict"]
    net = t_models.build_classifier("lstm", device="cpu", input_size=288, hidden_size=16,
                                    num_layers=2, bidirectional=True)
    net.load_state_dict(t_ckpt.load_classifier_state(ckpt), strict=True)
    with open(tmp_path / "GT_predY.csv", encoding="ISO-8859-1") as f:
        table = list(csv.reader(f))
    assert table[0] == ["GT", "predY"] and len(table) == 1 + 8  # 8 val clips, B=4
    # a second run with the same seeds gives the same epochs, dropout included
    again = _lstm_args(t_cli, data_dir, str(tmp_path / "again"), device="cpu",
                       dropout=0.1, optimizer="NAdam", learning_rate=3e-3)
    t_cli.main(again)
    assert [r["loss_train"] for r in _metrics(again.models_dir)] == [
        r["loss_train"] for r in rows]


@pytest.mark.parametrize("value,want", [("True", True), ("T", True), ("true", True),
                                        ("False", False), ("1", False)])
def test_bidir_flag_is_read_as_the_root_cli_reads_it(value, want):
    # the root CLI turns the string into a bool in its __main__ block
    # (classifier_main.py:186), out of reach of a test: the cases are its rule
    assert t_cli.build_parser().parse_args(["--bidir", value]).bidir is want


@pytest.mark.parametrize("cli", [t_cli, t_mlp_cli], ids=["lstm", "mlp"])
def test_cli_defaults_to_cuda(cli, data_dir, tmp_path):
    args = cli.build_parser().parse_args(["--data_dir", data_dir,
                                          "--models_dir", str(tmp_path)])
    assert args.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(args)
    assert not os.listdir(tmp_path)  # refused before any work
