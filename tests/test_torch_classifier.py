"""The port's downstream classifiers against the JAX package's, on the CPU.

The same numpy-seeded inputs and the same weights (carried across with
``models/convert.classifier_state_dict`` / ``sentence_classifier_state_dict``)
go through both packages.  Tolerances are the JAX package's own parity
records (tests/test_classifier.py): the LSTM's eval logits atol 2e-5
(:342), the sentence MLP's 1e-6 (:430), one CE-on-last-timestep step loss
1e-5 and parameters 1e-4 (:385, :397); remat bit-equal (:433-451);
resident epochs 1e-6 with equal accuracies and predictions (:453-492).
The synthetic fixture's categories and embeddings are numpy's alone and
must be bit-equal; its geometry is held at tests/test_torch_geometry.py's
tolerances (xyz 1e-5, the IK round trip 1e-4).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_hand_pose_enhancement_for_sign_language_tpu.data import (
    categories as j_categories,
    synthetic as j_synthetic,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu.models.classifier import (
    ClassifLSTM as JClassifLSTM,
    SentenceClassifier as JSentenceClassifier,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu.train import (
    checkpoint as j_ckpt,
    classifier as j_cls,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data import (
    categories as t_categories,
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
    classifier as t_cls,
    optim as t_optim,
)

ROOT = Path(__file__).resolve().parents[1]
PORT = "multimodal_hand_pose_enhancement_for_sign_language_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax",
           "multimodal_hand_pose_enhancement_for_sign_language_tpu")
LSTM_ATOL = 2e-5
MLP_ATOL = 1e-6
STEP_LOSS_ATOL = 1e-5
STEP_PARAM_ATOL = 1e-4
RESIDENT_ATOL = 1e-6


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


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_lstm(x, H=8, L=2, bidir=True, seed=0):
    m = JClassifLSTM(hidden_size=H, num_layers=L, bidirectional=bidir, dropout=0.0)
    return m, _np(m.init({"params": jax.random.PRNGKey(seed)}, x, False)["params"])


def _port_lstm(params, D, H=8, L=2, bidir=True, **kw):
    net = t_models.build_classifier("lstm", device="cpu", input_size=D, hidden_size=H,
                                    num_layers=L, bidirectional=bidir, **kw)
    net.load_state_dict(convert.classifier_state_dict(params), strict=True)
    return net


@pytest.mark.parametrize("bidir", [False, True], ids=["unidirectional", "bidirectional"])
def test_lstm_eval_logits_match_jax(rng, bidir):
    x = rng.randn(3, 9, 12).astype(np.float32)
    m, params = _jax_lstm(x, bidir=bidir)
    want = np.asarray(m.apply({"params": params}, x, False))
    net = _port_lstm(params, 12, bidir=bidir)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 9, 10)
    np.testing.assert_allclose(got, want, atol=LSTM_ATOL)


def test_lstm_state_dict_has_the_reference_keys():
    net = t_models.build_classifier("lstm", device="cpu", input_size=12, hidden_size=8,
                                    num_layers=2, bidirectional=True)
    keys = list(net.state_dict())
    want = [f"lstm.{w}_l{k}{s}" for k in range(2) for s in ("", "_reverse")
            for w in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
    assert keys == want + ["Linear.weight", "Linear.bias"]
    sd = net.state_dict()
    assert sd["lstm.weight_ih_l1_reverse"].shape == (32, 16)
    # a reference nn.LSTM stack with the same keys loads strictly, and back
    ref = torch.nn.LSTM(12, 8, num_layers=2, bidirectional=True, batch_first=True)
    ref_sd = {f"lstm.{k}": v for k, v in ref.state_dict().items()}
    ref_sd.update({k: sd[k] for k in ("Linear.weight", "Linear.bias")})
    net.load_state_dict(ref_sd, strict=True)
    for k, v in ref_sd.items():
        assert torch.equal(net.state_dict()[k], v), k
    x = torch.randn(2, 5, 12)
    with torch.no_grad():
        np.testing.assert_allclose(net(x).numpy(), net.Linear(ref(x)[0]).numpy(), atol=1e-6)
    with pytest.raises(RuntimeError, match="Missing key"):
        net.load_state_dict({k: v for k, v in ref_sd.items() if k != "lstm.bias_hh_l1"})


def test_lstm_init_is_uniform_within_one_over_sqrt_hidden():
    a = t_models.build_classifier("lstm", device="cpu", input_size=12, hidden_size=16,
                                  num_layers=2, bidirectional=False)
    b = t_models.build_classifier("lstm", device="cpu", input_size=12, hidden_size=16,
                                  num_layers=2, bidirectional=False)
    bound = 1 / 4.0
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k  # a function of the seed
        if k.startswith("lstm."):
            assert float(v.abs().max()) <= bound
            assert float(v.abs().max()) > 0.8 * bound
    assert float(a.state_dict()["Linear.weight"].abs().max()) <= 1 / np.sqrt(16)


def test_sentence_classifier_matches_jax(rng):
    x = rng.randn(5, 384).astype(np.float32)
    m = JSentenceClassifier()
    params = _np(m.init({"params": jax.random.PRNGKey(0)}, x, False)["params"])
    want = np.asarray(m.apply({"params": params}, x, False))
    net = t_models.build_classifier("mlp", device="cpu")
    net.load_state_dict(convert.sentence_classifier_state_dict(params), strict=True)
    assert sorted(net.state_dict()) == ["classifier.0.bias", "classifier.0.weight",
                                        "classifier.2.bias", "classifier.2.weight"]
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=MLP_ATOL)


@pytest.mark.parametrize("optimizer", ["Adam", "AdamW", "NAdam"])
def test_train_step_matches_jax(rng, optimizer):
    """One CE-on-last-timestep step, weight decay 1e-3, dropout 0."""
    B, T, D, lr = 4, 7, 12, 1e-3
    x = rng.randn(B, T, D).astype(np.float32)
    labels = rng.randint(1, 11, size=(B,))
    m, params = _jax_lstm(x)
    jt = j_cls.ClassifierTrainer(m, learning_rate=lr, weight_decay=1e-3, optimizer=optimizer)
    p = jax.tree.map(jnp.asarray, params)
    p1, _, j_loss, j_acc = jt._train_step(p, jt.tx.init(p), jnp.asarray(x),
                                          jnp.asarray(labels - 1), jax.random.PRNGKey(0))
    net = _port_lstm(params, D)
    tt = t_cls.ClassifierTrainer(net, learning_rate=lr, weight_decay=1e-3, optimizer=optimizer)
    loss, acc = tt.train_step(torch.from_numpy(x), torch.from_numpy(labels - 1))
    assert abs(float(loss) - float(j_loss)) <= STEP_LOSS_ATOL
    assert int(acc) == int(j_acc)
    want = convert.classifier_state_dict(_np(p1))
    got = net.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=STEP_PARAM_ATOL, err_msg=k)


def test_nadam_is_optaxs_not_torchs():
    """From p = (0.5, -1, 2) with the gradients g, 2g, 3g, g = (0.1, -0.2,
    0.3), at lr 1e-2: optax's NAdam ends at 0.46060, torch's at 0.47019."""
    import optax

    g = np.array([0.1, -0.2, 0.3], np.float32)
    p0 = np.array([0.5, -1.0, 2.0], np.float32)
    p, q = (torch.tensor(p0, requires_grad=True) for _ in range(2))
    ours = t_optim.make_optimizer("NAdam", [p], 1e-2, 0.0)
    theirs = torch.optim.NAdam([q], lr=1e-2)
    tx = optax.nadam(1e-2)
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    for k in (1, 2, 3):
        p.grad, q.grad = torch.tensor(g * k), torch.tensor(g * k)
        ours.step()
        theirs.step()
        u, state = tx.update(jnp.asarray(g * k), state, jp)
        jp = optax.apply_updates(jp, u)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), atol=1e-6)
    assert abs(float(jp[0]) - 0.46060) < 1e-5
    assert abs(float(q.detach()[0]) - 0.47019) < 1e-5


def test_unknown_optimizer_raises():
    with pytest.raises(KeyError, match="SGD"):
        t_optim.make_optimizer("SGD", [torch.zeros(1, requires_grad=True)], 1e-3, 0.0)


def test_remat_is_exact(rng):
    """remat=True recomputes each layer in the backward pass: outputs and
    gradients bit-equal to the plain run."""
    x = torch.from_numpy(rng.randn(2, 12, 8).astype(np.float32))
    kw = dict(input_size=8, hidden_size=16, num_layers=2, bidirectional=True)
    plain = t_models.build_classifier("lstm", device="cpu", **kw)
    remat = t_models.build_classifier("lstm", device="cpu", remat=True, **kw)
    for net in (plain, remat):
        net.train()
        net.zero_grad()
        net(x).sum().backward()
    with torch.no_grad():
        assert torch.equal(plain(x), remat(x))
    for (k, a), b in zip(plain.state_dict(keep_vars=True).items(),
                         remat.state_dict(keep_vars=True).values()):
        assert torch.equal(a.grad, b.grad), k


def test_inter_layer_dropout_comes_from_the_trainers_generator(rng):
    """Dropout between layers only: with one layer p has no effect; with two
    the masks are a function of the trainer's dropout seed alone."""
    x = rng.randn(4, 6, 8).astype(np.float32)
    y = rng.randint(1, 11, size=(4,))
    kw = dict(input_size=8, hidden_size=16, bidirectional=False)

    def step(layers, p, seed):
        net = t_models.build_classifier("lstm", device="cpu", num_layers=layers,
                                        dropout=p, **kw)
        tr = t_cls.ClassifierTrainer(net, dropout_seed=seed)
        return float(tr.train_step(torch.from_numpy(x), torch.from_numpy(y - 1))[0])

    assert step(1, 0.5, 2) == step(1, 0.0, 2)
    torch.manual_seed(0)
    a = step(2, 0.5, 2)
    torch.manual_seed(1)  # the global generator plays no part
    assert step(2, 0.5, 2) == a
    assert step(2, 0.5, 3) != a
    assert step(2, 0.0, 2) != a


def test_resident_epochs_match_host_fed(rng):
    """Staged epochs with a composed permutation equal the host-fed ones on
    the permuted arrays, across a shuffle boundary."""
    X = rng.randn(12, 10, 8).astype(np.float32)
    Y = rng.randint(1, 11, size=12)
    I = np.random.RandomState(0).permutation(12)

    def trainer():
        net = t_models.build_classifier("lstm", device="cpu", input_size=8, hidden_size=8,
                                        num_layers=1, bidirectional=False)
        return t_cls.ClassifierTrainer(net)

    t1 = trainer()
    l1a, acc1a = t1.train_epoch(X, Y, 4)
    l1b, acc1b = t1.train_epoch(X[I], Y[I], 4)
    vl1, va1, (GT1, P1) = t1.val_epoch(X, Y, 4)

    t2 = trainer()
    dX, dY = t2.stage(X, Y)
    order = np.arange(12)
    l2a, acc2a = t2.train_epoch_resident(dX, dY, order, 4)
    l2b, acc2b = t2.train_epoch_resident(dX, dY, order[I], 4)
    vl2, va2, (GT2, P2) = t2.val_epoch_resident(dX, dY, 4)

    assert len(l1a) == len(l1b) == 3
    np.testing.assert_allclose(l1a, l2a, atol=RESIDENT_ATOL)
    np.testing.assert_allclose(l1b, l2b, atol=RESIDENT_ATOL)
    assert (acc1a, acc1b) == (acc2a, acc2b)
    assert abs(vl1 - vl2) < RESIDENT_ATOL and va1 == va2
    assert GT1 == GT2 == (Y - 1).tolist() and P1 == P2
    for (k, a), b in zip(t1.module.state_dict().items(), t2.module.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=RESIDENT_ATOL, err_msg=k)


def test_val_epoch_matches_jax(rng):
    """Loss sum, accuracy, GT and predictions of a val epoch, labels 1-based."""
    X = rng.randn(10, 7, 12).astype(np.float32)
    Y = rng.randint(1, 11, size=10)
    m, params = _jax_lstm(X[:2])
    jt = j_cls.ClassifierTrainer(m)
    jl, ja, (jGT, jP) = jt.val_epoch(jax.tree.map(jnp.asarray, params), X, Y, 4)
    tt = t_cls.ClassifierTrainer(_port_lstm(params, 12))
    tl, ta, (tGT, tP) = tt.val_epoch(X, Y, 4)
    assert abs(tl - jl) <= 2 * STEP_LOSS_ATOL and ta == ja
    assert tGT == [int(v) for v in jGT] and tP == [int(v) for v in jP]


def _write_grouped(d, rng):
    """Truer6d / Truecategs (long grouped clips, one with a NaN) and
    wordBert embeddings, for both splits."""
    for key in ("train", "val"):
        clips = [rng.randn(int(t), 288).astype(np.float32) for t in (150, 400, 2500, 700)]
        clips[1][3, 5] = np.nan
        save_binary(clips, os.path.join(d, f"Truer6d_{key}.pkl"))
        save_binary([3, 1, 9, 4], os.path.join(d, f"Truecategs_{key}.pkl"))
        save_binary(rng.randn(4, 768).astype(np.float32),
                    os.path.join(d, f"{key}_wordBert_embeddings.pkl"))


@pytest.mark.parametrize("data_type", ["r6d", "grouped_r6d", "wordBert"])
def test_load_data_matches_jax(tmp_path, rng, data_type):
    d = str(tmp_path)
    t_synthetic.make_r6d_dataset(d, n_clips=6, t_range=(40, 240), seed=3,
                                 save_image_feats=False, device="cpu")
    _write_grouped(d, rng)
    for key in ("train", "val"):
        jX, jY = j_cls.load_data(d, data_type, key)
        tX, tY = t_cls.load_data(d, data_type, key)
        assert tX.dtype == jX.dtype == np.float32
        np.testing.assert_array_equal(tX, jX)
        np.testing.assert_array_equal(tY, jY)
    if data_type == "grouped_r6d":
        assert tX.shape == (3, 2112, 288)  # the NaN clip dropped, padded to 2112


@pytest.mark.parametrize("cfg", [
    (128, 192, 1024, 10, True), (128, 192, 1024, 10, False), (32, 192, 1024, 10, True),
    (128, 2112, 1024, 10, False), (8, 192, 64, 2, False),
])
def test_remat_policy_matches_jax(cfg):
    gb16, gb80 = 16 * (1 << 30), 80 * (1 << 30)
    assert t_cls.lstm_activation_bytes(*cfg) == j_cls.lstm_activation_bytes(*cfg)
    for limit in (gb16, gb80):
        assert (t_cls.should_remat(*cfg, memory_limit_bytes=limit)
                == j_cls.should_remat(*cfg, memory_limit_bytes=limit))
    # off the accelerator both answer False
    assert t_cls.should_remat(*cfg, device="cpu") is False
    assert j_cls.should_remat(*cfg) is False


@pytest.mark.parametrize("categ_signal,save_image_feats", [(True, True), (False, False)])
def test_synthetic_dataset_matches_jax(tmp_path, categ_signal, save_image_feats):
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    kw = dict(n_clips=8, t_range=(40, 140), seed=7, categ_signal=categ_signal, text_dim=384,
              save_image_feats=save_image_feats)
    j_synthetic.make_r6d_dataset(a, **kw)
    t_synthetic.make_r6d_dataset(b, device="cpu", **kw)
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for f in sorted(os.listdir(a)):
        ja, tb = load_binary(os.path.join(a, f)), load_binary(os.path.join(b, f))
        if f.startswith(("r6d_", "xyz_")):
            assert [c.shape for c in ja] == [c.shape for c in tb]
            atol = 1e-4 if f.startswith("r6d_") else 1e-5
            for x, y in zip(ja, tb):
                np.testing.assert_allclose(y, x, atol=atol, err_msg=f)
        else:  # categories, embeddings and image features: numpy's alone
            assert len(ja) == len(tb)
            for x, y in zip(ja, tb):
                np.testing.assert_array_equal(np.asarray(y), np.asarray(x), err_msg=f)


def test_openpose_tree_matches_jax(tmp_path):
    ja = j_synthetic.make_openpose_tree(str(tmp_path / "j"), frames=3, seed=4)
    tb = t_synthetic.make_openpose_tree(str(tmp_path / "t"), frames=3, seed=4)
    for split, path in ja["categ_paths"].items():
        assert (t_categories.get_ids_categ(tb["categ_paths"][split])
                == j_categories.get_ids_categ(path))
    for split, path in ja["text_paths"].items():
        assert Path(path).read_text() == Path(tb["text_paths"][split]).read_text()
    for root, _, files in os.walk(tmp_path / "j"):
        for f in files:
            if f.endswith(".json"):
                other = Path(str(root).replace(str(tmp_path / "j"), str(tmp_path / "t"))) / f
                assert json.loads(other.read_text()) == json.loads((Path(root) / f).read_text())


def test_categories_match_jax(tmp_path):
    path = tmp_path / "videoID_categoryID_train.csv"
    path.write_text("videoID,categoryID\nvid00000000,3\nvid00000001,7\nvid00000000,5\n")
    ids = t_categories.get_ids_categ(str(path))
    assert ids == j_categories.get_ids_categ(str(path)) == {"vid00000000": 3, "vid00000001": 7}
    names = ["vid00000001-0-rgb_front", "vid00000000-2-rgb_front"]
    assert t_categories.get_clips_categ(names, ids) == j_categories.get_clips_categ(names, ids)
    rel = t_categories.counter_to_relative({1: 1, 2: 3})
    assert rel == j_categories.counter_to_relative({1: 1, 2: 3}) == {1: 0.25, 2: 0.75}


def test_pth_round_trip_is_strict(tmp_path, rng):
    net = t_models.build_classifier("lstm", device="cpu", input_size=12, hidden_size=8,
                                    num_layers=2, bidirectional=True)
    tr = t_cls.ClassifierTrainer(net)
    x = rng.randn(2, 5, 12).astype(np.float32)
    tr.train_step(torch.from_numpy(x), torch.tensor([0, 3]))
    path = str(tmp_path / "exp_checkpoint.pth")
    t_ckpt.save_checkpoint(path, tr.checkpoint_payload(4))
    sd = t_ckpt.load_classifier_state(path)
    fresh = t_models.build_classifier("lstm", device="cpu", seed=9, input_size=12,
                                      hidden_size=8, num_layers=2, bidirectional=True)
    fresh.load_state_dict(sd, strict=True)
    for k, v in net.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    assert t_ckpt.load_checkpoint(path)["epoch"] == 4


_CHILD = r"""
import json, sys
for name in {blocked!r}:
    sys.modules[name] = None  # any import of these raises ImportError
import numpy as np
from {port}.models import classifier
from {port}.train import checkpoint
out = {{}}
for kind, path, kw in {cases!r}:
    sd = checkpoint.load_classifier_state(path)
    net = classifier.build_classifier(kind, device="cpu", **kw)
    net.load_state_dict(sd, strict=True)
    out.update({{kind + "/" + k: v.numpy() for k, v in net.state_dict().items()}})
np.savez({npz!r}, **out)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in {blocked!r} and sys.modules[m] is not None)
print(json.dumps({{"leaked": leaked}}))
"""


def test_reads_jax_classifier_pickles_without_jax(tmp_path, rng):
    """The JAX CLIs' ``{'epoch', 'params', 'opt_state'}`` pickles (optax
    state inside) load into the port's classifiers, strictly, in a process
    where jax, flax, optax and the JAX package cannot be imported."""
    x = rng.randn(2, 5, 12).astype(np.float32)
    m, lstm_params = _jax_lstm(x)
    mlp = JSentenceClassifier(in_dim=384)
    mlp_params = _np(mlp.init({"params": jax.random.PRNGKey(1)}, rng.randn(2, 384)
                              .astype(np.float32), False)["params"])
    cases = []
    for kind, module, params, kw in (
            ("lstm", m, lstm_params, dict(input_size=12, hidden_size=8, num_layers=2,
                                          bidirectional=True)),
            ("mlp", mlp, mlp_params, {})):
        tr = j_cls.ClassifierTrainer(module, optimizer="NAdam")
        path = str(tmp_path / f"{kind}_checkpoint.pkl")
        j_ckpt.save_checkpoint(path, {"epoch": 2, "params": params,
                                      "opt_state": tr.tx.init(params)})
        cases.append((kind, path, kw))
    npz = str(tmp_path / "sd.npz")
    code = _CHILD.format(blocked=BLOCKED, port=PORT, cases=cases, npz=npz)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1])["leaked"] == []
    got = np.load(npz)
    want = {**{f"lstm/{k}": v for k, v in convert.classifier_state_dict(lstm_params).items()},
            **{f"mlp/{k}": v for k, v in
               convert.sentence_classifier_state_dict(mlp_params).items()}}
    assert sorted(got.files) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)


def test_mlp_learns_signal_embeds(tmp_path):
    """The JAX package's bar (tests/test_classifier.py:198-226): class-centroid
    embeddings are separable, best val accuracy > 0.5 within 60 epochs."""
    d = str(tmp_path)
    t_synthetic.make_r6d_dataset(d, n_clips=54, t_range=(40, 60), seed=7, text_dim=384,
                                 save_image_feats=False, categ_signal=True, device="cpu")
    X_tr, Y_tr = (np.asarray(load_binary(f"{d}/{f}.pkl"))
                  for f in ("train_sentence_embeddings", "categs_train"))
    X_va, Y_va = (np.asarray(load_binary(f"{d}/{f}.pkl"))
                  for f in ("val_sentence_embeddings", "categs_val"))
    net = t_models.build_classifier("mlp", device="cpu", seed=0)
    tr = t_cls.ClassifierTrainer(net, learning_rate=1e-3, weight_decay=0.0,
                                 last_timestep_only=False)
    best = 0.0
    for _ in range(60):
        tr.train_epoch(X_tr, Y_tr, 16)
        best = max(best, tr.val_epoch(X_va, Y_va, 16)[1])
    assert best > 0.5, best


def test_lstm_learns_signal_fixture(tmp_path):
    """The JAX package's bar (tests/test_classifier.py:166-195): a small LSTM
    (hidden 64, one layer, Adam 3e-3) on the categ_signal fixture, best val
    accuracy > 0.4 within 60 epochs (chance is 1/9)."""
    d = str(tmp_path)
    t_synthetic.make_r6d_dataset(d, n_clips=54, t_range=(60, 140), seed=7,
                                 save_image_feats=False, categ_signal=True, device="cpu")
    (X_tr, Y_tr), (X_va, Y_va) = (t_cls.load_data(d, "r6d", k) for k in ("train", "val"))
    net = t_models.build_classifier("lstm", device="cpu", seed=0, input_size=288,
                                    hidden_size=64, num_layers=1, bidirectional=False)
    tr = t_cls.ClassifierTrainer(net, learning_rate=3e-3, weight_decay=0.0)
    best = 0.0
    for _ in range(60):
        tr.train_epoch(X_tr, Y_tr, 16)
        best = max(best, tr.val_epoch(X_va, Y_va, 16)[1])
    assert best > 0.4, best
