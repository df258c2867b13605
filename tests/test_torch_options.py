"""The port's training and serving options against the JAX package's, on the CPU.

Small size (T=32, 12 -> 24, default_size 32, B=8), the JAX trainer's
initial state carried into the port by ``models/convert`` as in
tests/test_torch_gan.py (dropout 0).

Tolerances:
* bf16 ``run_inference``: within 2 x the JAX package's own bf16-vs-float32
  distance of the JAX bf16 output, and within the JAX package's bars for
  bf16 against float32 (max < 0.15, mean < 0.02,
  tests/test_inference_lib.py:55-63).
* one bf16 G and one bf16 D step: the JAX package's own bar, the loss
  within 5% of the float32 loss (tests/test_train_extensions.py:47-62),
  held between the two packages' bf16 steps and between the port's bf16 and
  float32 steps; the bf16 backward through Adam's first moment after the
  step, (1 - b1) g in both packages: each tensor's gradient within 3 x the
  JAX package's own bf16-vs-float32 distance of JAX's bf16 gradient (in
  norm, relative to it) and below 0.75 whatever that distance (a zeroed
  gradient is 1 away, a flipped one 2; measured: at most 1.84 x and 0.53,
  the BatchNorm backward's cancellation makes bf16 gradients 1-55% from
  float32 in both packages); running statistics within 2^-5 of each
  tensor's largest value: bf16 keeps 8 bits, and the two packages round at
  different points (XLA keeps excess precision inside fused bf16 chains,
  PyTorch rounds every op), so a statistic may land a few bf16 steps apart;
  the D's last BatchNorm, over 8 values, measured 3.7.
* ``fused_d``: the step tolerances (loss and every parameter and
  statistic within 5e-6, tests/test_torch_gan.py) against the port's
  sequential step, and ``_hold_state`` against the JAX package's fused step;
  in bf16 each tensor's gradient within 2^-6 of the sequential step's
  (measured 6.2e-3: the two forms round the same operations apart).
* ``grad_flow``: each tensor's mean and max |g| within 1e-5 relative of the
  JAX package's, the JAX tensors mapped onto the port's names by
  ``models/convert`` (both statistics ignore the kernels' transposition).
* ``load_data`` on float64 clips and through the cache: bit for bit.
* ``fit_partition_spline.fit``: equal to the JAX package's.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

import jax

from multimodal_hand_pose_enhancement_for_sign_language_tpu import infer as j_infer
from multimodal_hand_pose_enhancement_for_sign_language_tpu.data import (
    synthetic as j_synthetic,
    text as j_text,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu.losses.robust import (
    fit_partition_spline as j_fit,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu.models import (
    registry as j_registry,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu.train import (
    data as j_data,
    gan as j_gan,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch import (
    infer as t_infer,
    inference as t_inference,
    train_gan as t_cli,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data import text
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.losses.robust import (
    fit_partition_spline as t_fit,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models import (
    convert,
    registry as t_registry,
    resnet,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.train import (
    data as t_data,
    gan as t_gan,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.viz import track_grads
from test_torch_gan import STEP_ATOL, _hold_state, _Pair

BF16_FWD_MAX, BF16_FWD_MEAN = 0.15, 0.02  # tests/test_inference_lib.py:55-63
BF16_LOSS_REL = 0.05  # tests/test_train_extensions.py:62
BF16_STAT_REL = 2.0**-5
BF16_GRAD_RATIO, BF16_GRAD_REL = 3.0, 0.75
FUSED_GRAD_REL = 2.0**-6
GRAD_FLOW_RTOL = 1e-5
TEXT_ATOL = 2e-5  # tests/test_torch_featurizers.py


# ---------------------------------------------------------------------------
# bf16 inference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model,cond", [("v1", None), ("v4", "text")])
def test_bf16_inference_matches_jax(rng, model, cond):
    module = j_registry.build_generator(model, 12, 8, default_size=32,
                                        require_text=cond == "text")
    variables = j_registry.init_generator(module, jax.random.PRNGKey(0), batch=2, T=32,
                                          feats_dim=512 if cond else None)
    X = rng.randn(6, 32, 12).astype(np.float32)
    F = rng.randn(6, 512).astype(np.float32) if cond else None
    j32, _ = j_infer.run_inference(module, variables, X, F, batch_size=4,
                                   matmul_precision="float32")
    j16, _ = j_infer.run_inference(module, variables, X, F, batch_size=4, bf16=True)
    net = t_registry.build_generator(model, 12, 8, default_size=32,
                                     require_text=cond == "text", device="cpu")
    net.load_state_dict(convert.generator_state_dict(jax.tree.map(np.asarray, variables)),
                        strict=True)
    t16, _ = t_infer.run_inference(net, X, F, batch_size=4, device="cpu", bf16=True)
    t32, _ = t_infer.run_inference(net, X, F, batch_size=4, device="cpu")
    assert t16.dtype == np.float32 and t16.shape == j16.shape == (6, 32, 8)
    # the caller's model is untouched: float32, the same outputs
    assert all(p.dtype == torch.float32 for p in net.parameters())
    again, _ = t_infer.run_inference(net, X, F, batch_size=4, device="cpu")
    np.testing.assert_array_equal(again, t32)
    jax_dist = float(np.abs(j16 - j32).max())
    assert 0 < float(np.abs(t16 - j16).max()) <= 2 * jax_dist
    assert np.abs(t16 - t32).max() < BF16_FWD_MAX
    assert np.abs(t16 - t32).mean() < BF16_FWD_MEAN
    assert np.abs(t16 - t32).max() > 0  # it did run in bf16


def test_inference_cli_passes_bf16(monkeypatch):
    """``--bf16`` reaches ``run_inference`` (the root CLI's flag)."""
    seen = {}

    class Stop(Exception):
        pass

    def spy(*a, **k):
        seen.update(k)
        raise Stop

    args = t_inference.build_parser().parse_args(["--bf16", "--device", "cpu"])
    assert args.bf16 and not t_inference.build_parser().parse_args([]).bf16
    monkeypatch.setattr(t_inference.win_lib, "load_windows",
                        lambda *a, **k: (np.zeros((2, 192, 36), np.float32),
                                         np.zeros((2, 192, 252), np.float32), [0, 1]))
    monkeypatch.setattr(t_inference.std_lib, "load_standardization",
                        lambda p: (np.zeros((1, 36, 1)), np.ones((1, 36, 1)),
                                   np.zeros((1, 252, 1)), np.ones((1, 252, 1))))
    monkeypatch.setattr(t_inference, "load_generator_state",
                        lambda p: t_registry.build_generator("v1", 36, 252,
                                                             device="cpu").state_dict())
    monkeypatch.setattr(t_inference.infer_lib, "run_inference", spy)
    with pytest.raises(Stop):
        t_inference.main(args)
    assert seen["bf16"] is True


# ---------------------------------------------------------------------------
# bf16 training steps, fused_d, grad_flow
# ---------------------------------------------------------------------------

def _pair(compute_dtype="float32", fused_d=False, model="v1", cond=None):
    p = _Pair("RobustLoss", True, model, cond)
    cfg = p.jax.cfg
    cfg.compute_dtype, cfg.fused_d = compute_dtype, fused_d
    p.jax = j_gan.GanTrainer(cfg)
    return p


def _port(p, **over):
    """A port trainer holding the pair's JAX initial state, its config's
    fields ``over`` set."""
    tr = p.port()
    cfg = t_gan.GanConfig(**{**vars(tr.cfg), **over})
    new = t_gan.GanTrainer(cfg, device="cpu")
    new.generator.load_state_dict(tr.generator.state_dict())
    new.discriminator.load_state_dict(tr.discriminator.state_dict())
    new.adaptive.load_state_dict(tr.adaptive.state_dict())
    return new


def _state_dicts(st, kind):
    st = jax.tree.map(np.asarray, {k: v for k, v in st.items() if k != "rng"})
    if kind == "g":
        return convert.generator_state_dict({"params": st["g_params"],
                                             "batch_stats": st["g_stats"]})
    return convert.discriminator_state_dict({"params": st["d_params"],
                                             "batch_stats": st["d_stats"]})


def _jax_first_moments(st, kind):
    """Adam's first moment after one JAX step, (1 - b1) g, on the port's
    parameter names."""
    mu = jax.tree.map(np.asarray, st[f"{kind}_opt"].inner_state[0].mu)
    stats = jax.tree.map(lambda a: np.zeros(np.shape(a), np.float32), st[f"{kind}_stats"])
    to_port = (convert.generator_state_dict if kind == "g"
               else convert.discriminator_state_dict)
    return to_port({"params": mu, "batch_stats": stats})


def _port_first_moments(tr, kind):
    """Adam's first moment after one port step, (1 - b1) g, for each
    parameter the step reached."""
    module = tr.generator if kind == "g" else tr.discriminator
    opt = tr.g_opt if kind == "g" else tr.d_opt
    return {k: opt.state[q]["exp_avg"] for k, q in module.named_parameters()
            if q in opt.state}


def _grad_dist(got, want):
    """Each tensor's distance from ``want``, in norm, relative to it."""
    return {k: float((v - want[k]).norm() / want[k].norm()) for k, v in got.items()}


@pytest.mark.parametrize("kind", ["g", "d"])
def test_bf16_step_matches_jax(kind):
    p16, p32 = _pair("bfloat16"), _pair("float32")
    st, j16 = getattr(p16.jax, f"_{kind}_step")(p16.jax_state(), *p16.jax_args())
    st32, j32 = getattr(p32.jax, f"_{kind}_step")(p32.jax_state(), *p32.jax_args())
    tr = _port(p16, compute_dtype="bfloat16")
    t16 = float(getattr(tr, f"{kind}_step")(*p16.port_args()))
    t32 = float(getattr(_port(p16), f"{kind}_step")(*p16.port_args()))
    j16, j32 = float(j16), float(j32)
    assert t16 != t32  # the step ran in bf16
    assert abs(t16 - j16) <= BF16_LOSS_REL * max(abs(j32), 1.0)
    assert abs(t16 - t32) <= BF16_LOSS_REL * max(abs(t32), 1.0)
    # the bf16 backward, tensor by tensor, against JAX's bf16 gradient
    got, want = _port_first_moments(tr, kind), _jax_first_moments(st, kind)
    module = tr.generator if kind == "g" else tr.discriminator
    assert len(got) == sum(q.grad is not None for q in module.parameters()) > 0
    jax_dist = _grad_dist({k: want[k] for k in got}, _jax_first_moments(st32, kind))
    for k, d in _grad_dist(got, want).items():
        assert d <= min(BF16_GRAD_REL, BF16_GRAD_RATIO * jax_dist[k]), (k, d, jax_dist[k])
    # which a zeroed or a sign-flipped gradient fails on every tensor
    for bad in ({k: torch.zeros_like(v) for k, v in got.items()},
                {k: -v for k, v in got.items()}):
        assert min(_grad_dist(bad, want).values()) > BF16_GRAD_REL
    want = _state_dicts(st, kind)
    for k, v in module.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        assert v.dtype == torch.float32, k  # master weights and statistics stay float32
        if "running" in k:
            err = float((v - want[k]).abs().max())
            assert err <= BF16_STAT_REL * float(want[k].abs().max()), (k, err)
    opt = tr.g_opt if kind == "g" else tr.d_opt
    assert all(s.dtype == torch.float32 for st_ in opt.state.values()
               for s in st_.values() if s.is_floating_point())


@pytest.mark.parametrize("kind", ["g", "d", "val"])
def test_float32_compute_keeps_the_modules_dtype(kind):
    """At compute_dtype float32 a step casts nothing: a trainer moved to
    float64 (``chip_smoke.py``'s reference step) steps in float64."""
    p = _pair()
    tr = p.port()
    for m in (tr.generator, tr.discriminator, tr.adaptive):
        m.double()
    loss = tr._step(kind)(*(None if a is None else a.double() for a in p.port_args()))
    assert loss.dtype == torch.float64


def test_bf16_val_step_and_config(rng):
    p = _pair("bfloat16")
    want = float(p.jax._val_step(p.jax_state(), *p.jax_args()))
    got = float(_port(p, compute_dtype="bfloat16").val_step(*p.port_args()))
    assert abs(got - want) <= BF16_LOSS_REL * max(abs(want), 1.0)
    with pytest.raises(ValueError, match="compute_dtype"):
        t_gan.GanTrainer(t_gan.GanConfig(compute_dtype="float16"), device="cpu")


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_fused_d_step_matches_the_sequential_step(compute_dtype):
    """One D forward over both passes takes the sequential step, the
    running statistics recovered algebraically, and the JAX package's
    fused step: in float32 at the step tolerances (loss, parameters and
    statistics within 5e-6 of the sequential step; ``_hold_state`` against
    JAX's), in bf16 at the bf16 bounds: the loss and statistics as in
    ``test_bf16_step_matches_jax``, each gradient within FUSED_GRAD_REL of
    the sequential step's."""
    p = _pair(compute_dtype, fused_d=True)
    seq = _port(p, compute_dtype=compute_dtype)
    fused = _port(p, compute_dtype=compute_dtype, fused_d=True)
    ls = float(seq.d_step(*p.port_args()))
    lf = float(fused.d_step(*p.port_args()))
    st, jl = p.jax._d_step(p.jax_state(), *p.jax_args())
    jl = float(jl)
    assert int(fused.discriminator.convs[3].num_batches_tracked) == 2
    a, b = seq.discriminator.state_dict(), fused.discriminator.state_dict()
    if compute_dtype == "float32":
        assert abs(lf - ls) <= STEP_ATOL * max(1.0, abs(ls))
        for k in a:
            assert float((a[k].double() - b[k].double()).abs().max()) <= STEP_ATOL, k
        assert abs(lf - jl) <= STEP_ATOL * max(1.0, abs(jl))
        assert _hold_state(fused.discriminator, _state_dicts(st, "d")) <= 1e-3
        return
    assert abs(lf - ls) <= BF16_LOSS_REL * max(1.0, abs(ls))
    assert abs(lf - jl) <= BF16_LOSS_REL * max(1.0, abs(jl))
    for k in a:
        if "running" in k:
            assert float((a[k] - b[k]).abs().max()) <= BF16_STAT_REL * float(a[k].abs().max()), k
    got, want = _port_first_moments(fused, "d"), _port_first_moments(seq, "d")
    assert sorted(got) == sorted(want) and got
    for k, d in _grad_dist(got, want).items():
        assert d <= FUSED_GRAD_REL, (k, d)


def _jax_names_by_port_key(params, stats):
    """Each port parameter name -> the JAX grad_flow key of the same tensor:
    every leaf replaced by its index, mapped through ``convert``."""
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    names = ["/".join(str(getattr(q, "key", q)) for q in path) for path, _ in flat]
    index_tree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params),
        [np.full(np.shape(leaf), i, np.float32) for i, (_, leaf) in enumerate(flat)])
    stats = jax.tree.map(lambda a: np.full(np.shape(a), -1, np.float32), stats)
    sd = convert.generator_state_dict({"params": index_tree, "batch_stats": stats})
    return {k: names[int(v.flatten()[0])] for k, v in sd.items()
            if v.is_floating_point() and float(v.flatten()[0]) >= 0}


@pytest.mark.parametrize("model,cond", [("v1", None), ("v4", "text")])
def test_grad_flow_matches_jax(model, cond):
    p = _pair(model=model, cond=cond)
    want = p.jax.grad_flow(p.jax_state(), *p.jax_args())
    keymap = _jax_names_by_port_key(p.state0["g_params"], p.state0["g_stats"])
    tr = p.port()
    before = {k: v.clone() for k, v in tr.generator.state_dict().items()}
    stream = tr.dropout_generator.get_state()
    got = tr.grad_flow(*p.port_args())
    assert sorted(got) == sorted(n for n, q in tr.generator.named_parameters()
                                 if n in keymap) and len(got) == len(want)
    for k, v in got.items():
        w = want[keymap[k]]
        for f in ("ave", "max"):
            assert abs(v[f] - w[f]) <= GRAD_FLOW_RTOL * abs(w[f]), (k, f, v[f], w[f])
    # no step: weights, statistics, gradients and the dropout stream untouched
    for k, v in tr.generator.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(q.grad is None for q in tr.generator.parameters())
    assert torch.equal(tr.dropout_generator.get_state(), stream)


def test_grad_flow_stats_and_plot(tmp_path):
    stats = track_grads.grad_flow_stats({"a.weight": torch.tensor([[1.0, -3.0]]),
                                         "a.bias": torch.tensor([0.5])})
    assert stats == {"a.weight": {"ave": 2.0, "max": 3.0},
                     "a.bias": {"ave": 0.5, "max": 0.5}}
    pytest.importorskip("matplotlib")
    out = track_grads.plot_grad_flow({"a.weight": torch.ones(3)}, str(tmp_path / "g.png"))
    assert os.path.getsize(out) > 0


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("options_cli")
    j_synthetic.make_r6d_dataset(os.path.join(d, "video_data"), n_clips=12,
                                 t_range=(60, 230), seed=11, save_image_feats=False)
    return d


def test_train_cli_bf16_logs_grad_flow(workdir, capsys):
    """``--bf16 --log_grad_flow 1``: two epochs in bf16 with float32
    checkpoints, and a grad-flow event each epoch in the root CLI's form
    (epoch, event, each parameter's mean |g|)."""
    args = t_cli.build_parser().parse_args([
        "--base_path", str(workdir), "--data_dir", os.path.join(workdir, "video_data"),
        "--model_path", os.path.join(workdir, "models"), "--exp_name", "bf16",
        "--num_epochs", "2", "--batch_size", "8", "--epochs_train_disc", "1",
        "--default_size", "32", "--loss", "RobustLoss", "--bf16", "--log_grad_flow", "1",
        "--device", "cpu"])
    best = t_cli.main(args)
    assert np.isfinite(best)
    with open(os.path.join(args.model_path, "metrics_bf16.jsonl")) as f:
        events = [json.loads(line) for line in f]
    flows = [e for e in events if e.get("event") == "grad_flow"]
    assert [e["epoch"] for e in flows] == [0, 1]
    names = {n for n, _ in t_registry.build_generator(
        "v1", 36, 252, default_size=32, device="cpu").named_parameters()}
    for e in flows:
        keys = set(e) - {"epoch", "event", "t"}  # the sink stamps each record with t
        assert keys == names and all(np.isfinite(e[k]) and e[k] >= 0 for k in keys)
    assert capsys.readouterr().out.count("grad-flow: max |g|") == 2
    sd = torch.load(os.path.join(args.model_path, "lastCheckpoint_bf16.pth"),
                    weights_only=False)["state_dict"]
    assert all(v.dtype in (torch.float32, torch.int64) for v in sd.values())


def test_train_cli_refuses_only_prng_impl():
    assert set(t_cli._NOT_PORTED) == {"prng_impl"}


# ---------------------------------------------------------------------------
# load_data: clips that are not float32, and the clip cache
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def float64_dir(tmp_path_factory):
    """The synthetic splits with their clips as float64 (one clip of train
    with a NaN frame, which drops it) and text embeddings."""
    d = tmp_path_factory.mktemp("f64") / "video_data"
    j_synthetic.make_r6d_dataset(str(d), n_clips=10, t_range=(60, 230), seed=5,
                                 save_image_feats=True)
    for split in ("train", "val"):
        path = d / f"r6d_{split}.pkl"
        with open(path, "rb") as f:
            clips = pickle.load(f)
        clips = [c.astype(np.float64) for c in clips]
        if split == "train":
            clips[1][5, 40] = np.nan
        with open(path, "wb") as f:
            pickle.dump(clips, f)
    return str(d)


@pytest.mark.parametrize("pipeline,feats", [
    ("arm2wh", None), ("wh2wh", None), ("arm2wh", "text"), ("arm2wh", "image"),
])
def test_load_data_on_float64_clips_matches_jax(float64_dir, tmp_path, pipeline, feats):
    kw = dict(require_text=feats == "text", require_image=feats == "image")
    want = j_data.load_data(float64_dir, pipeline, str(tmp_path / "j"), "e",
                            np.random.RandomState(23456), **kw)
    got = t_data.load_data(float64_dir, pipeline, str(tmp_path / "t"), "e",
                           np.random.RandomState(23456), **kw)
    for k in ("train_X", "train_Y", "val_X", "val_Y", "train_feats", "val_feats"):
        if want[k] is None:
            assert got[k] is None, k
            continue
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for a, b in zip(got["stats"], want["stats"]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got["train_X"].dtype == np.float32
    with open(os.path.join(float64_dir, "r6d_train.pkl"), "rb") as f:
        assert len(got["train_X"]) == len(pickle.load(f)) - 1  # the NaN clip dropped


LEGACY_REF = os.path.join(os.path.dirname(__file__), "data", "load_data_float64_ref.npz")
LEGACY_KEYS = ("train_X", "train_Y", "val_X", "val_Y")


def _legacy_reference(tmp):
    """The JAX package's ``load_data`` on ``synthetic.write_float64_r6d``'s
    seeded float64 clips (arm2wh): the arrays and statistics that
    ``chip_smoke.py`` holds the port's ``load_data`` to on the card's
    machine, which has no JAX."""
    from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data import synthetic

    d = synthetic.write_float64_r6d(os.path.join(tmp, "f64ref"))
    got = j_data.load_data(d, "arm2wh", os.path.join(tmp, "f64ref_stats"), "e",
                           np.random.RandomState(23456))
    return {**{k: got[k] for k in LEGACY_KEYS},
            **{f"stat{i}": a for i, a in enumerate(got["stats"])}}


def test_legacy_reference_file_is_the_jax_route(tmp_path):
    """The committed reference is the JAX legacy route's output, and the
    port's ``load_data`` gives it bit for bit here.  Rewrite it with
    ``PYTHONPATH=. python tests/test_torch_options.py``."""
    from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data import synthetic

    want = _legacy_reference(str(tmp_path))
    ref = np.load(LEGACY_REF)
    assert sorted(ref.files) == sorted(want)
    for k, v in want.items():
        assert ref[k].dtype == v.dtype and ref[k].shape == v.shape, k
        np.testing.assert_array_equal(ref[k], v, err_msg=k)
    d = synthetic.write_float64_r6d(str(tmp_path / "port"))
    got = t_data.load_data(d, "arm2wh", str(tmp_path / "stats"), "e",
                           np.random.RandomState(23456))
    for k in LEGACY_KEYS:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert ref["train_X"].shape == (1, 192, 36)  # the NaN clip dropped


def test_clip_cache_matches_jax_and_is_read_only(float64_dir, tmp_path, monkeypatch):
    """MHPE_LOAD_DATA_CACHE=1 loads each r6d pickle once, gives what the
    uncached load gives (float32 clips through the fused route, float64
    through the legacy one), and freezes the cached clips."""
    f32_dir = str(tmp_path / "f32")
    j_synthetic.make_r6d_dataset(f32_dir, n_clips=10, t_range=(60, 230), seed=5,
                                 save_image_feats=False)
    rs = np.random.RandomState
    uncached = {d: t_data.load_data(d, "arm2wh", str(tmp_path / "u"), "e", rs(23456))
                for d in (f32_dir, float64_dir)}
    monkeypatch.setenv("MHPE_LOAD_DATA_CACHE", "1")
    monkeypatch.setattr(t_data, "_CLIPS_CACHE", {})
    calls = []
    real = t_data.load_binary
    monkeypatch.setattr(t_data, "load_binary", lambda p: (calls.append(p), real(p))[1])
    for _ in range(2):
        for d in (f32_dir, float64_dir):
            got = t_data.load_data(d, "arm2wh", str(tmp_path / "c"), "e", rs(23456))
            want = j_data.load_data(d, "arm2wh", str(tmp_path / "j"), "e", rs(23456))
            for k in ("train_X", "train_Y", "val_X", "val_Y"):
                np.testing.assert_array_equal(got[k], uncached[d][k])
                np.testing.assert_array_equal(got[k], want[k])
    r6d = [p for p in calls if "r6d_" in os.path.basename(p)]
    assert len(r6d) == len(set(r6d)) == 4  # two splits of two directories, once each
    cached = next(iter(t_data._CLIPS_CACHE.values()))
    with pytest.raises(ValueError):
        cached[0][0, 0] = 1.0


@pytest.mark.parametrize("preset", [None, "0"])
def test_replay_keeps_the_clip_cache_for_its_run(monkeypatch, preset):
    """The port's ``article_replay.main`` runs with MHPE_LOAD_DATA_CACHE=1
    unless the caller set it (as the root script's setdefault does), and
    leaves the variable as it found it and the cache empty."""
    from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch import (
        article_replay as t_replay,
    )

    if preset is None:
        monkeypatch.delenv("MHPE_LOAD_DATA_CACHE", raising=False)
    else:
        monkeypatch.setenv("MHPE_LOAD_DATA_CACHE", preset)
    monkeypatch.setattr(t_data, "_CLIPS_CACHE", {"stale": []})
    seen = []
    monkeypatch.setattr(t_replay, "_replay",
                        lambda args: seen.append(os.environ.get("MHPE_LOAD_DATA_CACHE")) or 7)
    assert t_replay.main(t_replay.build_parser().parse_args(["--device", "cpu"])) == 7
    assert seen == [preset or "1"]
    assert os.environ.get("MHPE_LOAD_DATA_CACHE") == preset
    assert t_data._CLIPS_CACHE == {}


# ---------------------------------------------------------------------------
# fit_partition_spline
# ---------------------------------------------------------------------------

def test_fit_partition_spline_matches_jax():
    got, want = t_fit.fit(n_knots=12), j_fit.fit(n_knots=12)
    assert sorted(got) == sorted(want) == ["tangents", "values", "x_scale"]
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    # the analytic anchors log Z(0) = log(pi sqrt 2), log Z(2) = log(sqrt(2 pi))
    assert abs(np.log(t_fit.partition_z(0.0)) - np.log(np.pi * np.sqrt(2))) < 1e-9
    assert abs(np.log(t_fit.partition_z(2.0)) - np.log(np.sqrt(2 * np.pi))) < 1e-9


def test_fit_partition_spline_main_writes_the_ports_resource(tmp_path, monkeypatch):
    """``main`` writes resources/partition_spline_generated.npz beside the
    module (here a copy's), at the knots the port ships."""
    monkeypatch.setattr(t_fit, "__file__", str(tmp_path / "fit_partition_spline.py"))
    monkeypatch.setattr(t_fit, "fit", lambda: j_fit.fit(n_knots=8))
    t_fit.main()
    out = np.load(tmp_path / "resources" / "partition_spline_generated.npz")
    shipped = np.load(os.path.join(os.path.dirname(t_data.__file__), "..", "losses",
                                   "robust", "resources", "partition_spline_generated.npz"))
    assert sorted(out.files) == sorted(shipped.files)
    assert shipped["values"].shape == (t_fit.N_KNOTS,)


# ---------------------------------------------------------------------------
# the featurizer repairs and a known property
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def text_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("text") / "train.text.id.en"
    sentences = ["Hello world, this is sign language!", "the cat's hat is red."]
    path.write_text("".join(f"clip{i:07d}-1-rgb_front {s}\n" for i, s in enumerate(sentences)))
    return str(path), [f"clip{i:07d}-1-rgb_front" for i in range(len(sentences))]


def test_clip_route_takes_hidden_over_64_heads(text_file, tmp_path):
    """A CLIP text tower whose config says 2 heads of width 32: the JAX
    route takes hidden // 64 = 1 head, and so does the port's."""
    transformers = pytest.importorskip("transformers")
    from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.data import synthetic

    path, ids = text_file
    snap = synthetic.write_clip_snapshot(
        str(tmp_path / "clip"), ["Hello world, this is sign language!", "the cat's hat"],
        projection_dim=8,
        text=dict(hidden_size=64, num_hidden_layers=1, num_attention_heads=2,
                  intermediate_size=32),
        vision=dict(hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                    intermediate_size=32, image_size=32, patch_size=16))
    cfg = transformers.CLIPConfig.from_pretrained(snap)
    assert cfg.text_config.hidden_size // cfg.text_config.num_attention_heads != 64
    got = text.obtain_embeddings(path, ids, method="clip", weights_path=snap, device="cpu")
    want = j_text.obtain_embeddings(path, ids, method="clip", weights_path=snap)
    np.testing.assert_allclose(got, want, atol=TEXT_ATOL)


def test_resnet_path_without_pth_gives_the_random_tower(tmp_path):
    """As the JAX package's ``load_variables``: a ``weights_path`` that does
    not end in ``.pth`` is not read; the tower is the seeded random one."""
    other = resnet.load_resnet50(None, device="cpu",
                                 generator=torch.Generator().manual_seed(1))
    pt = str(tmp_path / "weights.pt")
    torch.save(other.state_dict(), pt)
    got = resnet.load_resnet50(pt, device="cpu")
    seeded = resnet.load_resnet50(None, device="cpu")
    for k, v in got.state_dict().items():
        assert torch.equal(v, seeded.state_dict()[k]), k
    pth = str(tmp_path / "weights.pth")
    torch.save(other.state_dict(), pth)
    assert torch.equal(resnet.load_resnet50(pth, device="cpu").fc.weight, other.fc.weight)


def test_bertword_on_a_short_snapshot_is_nan_in_jax_and_refused_here(text_file, tmp_path):
    """A known property: BERTword pads to 512 tokens whatever the snapshot's
    positions; on a 24-position snapshot the JAX route returns NaN (flax's
    out-of-range embedding lookups fill NaN), the port raises.  There is no
    result to match."""
    transformers = pytest.importorskip("transformers")
    d = tmp_path / "bert"
    d.mkdir()
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "hello", "world", "sign", "language"]
    (d / "vocab.txt").write_text("\n".join(vocab))
    transformers.BertTokenizer(str(d / "vocab.txt")).save_pretrained(str(d))
    torch.manual_seed(0)
    transformers.BertModel(transformers.BertConfig(
        vocab_size=len(vocab), hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
        intermediate_size=32, max_position_embeddings=24)).save_pretrained(str(d))
    path, ids = text_file
    want = j_text.obtain_embeddings(path, ids, method="BERTword", weights_path=str(d))
    assert np.isnan(want).any()
    with pytest.raises(ValueError, match="positions"):
        text.obtain_embeddings(path, ids, method="BERTword", weights_path=str(d),
                               device="cpu")


if __name__ == "__main__":
    import tempfile

    os.makedirs(os.path.dirname(LEGACY_REF), exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        np.savez_compressed(LEGACY_REF, **_legacy_reference(tmp))
    print(f"wrote {LEGACY_REF}")
