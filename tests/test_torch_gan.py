"""The port's discriminator and GAN steps against the JAX package's, on the CPU.

Small size (T=32, 12 -> 24, default_size 32, B=8).  The JAX trainer's
initial state (weights, perturbed BatchNorm statistics) is carried into the
port by ``models/convert``, and the same numpy-seeded batch goes through
one G step and one D step of each, with ``dropout_rate=0.0`` (the two
packages' dropout streams can never match).

Tolerances: the discriminator's eval forward 2e-4 (STATUS.md:363); losses,
post-Adam parameters and BatchNorm running statistics 5e-6 (STATUS.md:367).
Adam's first update is lr * g / (|g| + eps), so where |g| is float32
summation noise its sign may differ between the two frameworks: those
entries are masked, as the JAX package's own parity harness masks
0 < |g| < 1e-6 (parity_harness.py:273-298), their share must stay under
1e-3, and a masked entry may differ by the 2 * lr a flipped sign moves it,
no more.  On one step the float32 noise outgrows that fixed bound: v4+text's
D step, where the port's own float32 gradient of ``convs.5.weight`` is
1.09e-5 from a float64 evaluation at a largest entry of 0.853, and the JAX
package's sign differs from float64's at an entry of 4.0e-6.  For that
step alone the mask also covers |g| below 2^-16 of the tensor's largest
gradient (the port's measured float32 noise there); every other step keeps
the fixed 1e-6.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_hand_pose_enhancement_for_sign_language_tpu.models import (
    registry as j_registry,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu.train import gan as j_gan
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models import (
    convert,
    registry as t_registry,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.train import (
    gan as t_gan,
)

B, T, DIN, DOUT, SIZE = 8, 32, 12, 24, 32
FWD_ATOL = 2e-4  # STATUS.md:363
STEP_ATOL = 5e-6  # STATUS.md:367
NOISE = 1e-6  # |g| below this is float32 summation noise
# ... and, on v4+text's D step, below this share of the tensor's largest |g|
NOISE_REL = 2.0**-16
LR = 1e-4
MASKED_SHARE = 1e-3
# the BatchNorms of each model's branches whose output reaches nothing
DEAD_BRANCHES = {
    "v2": ("text_embeds_postprocess",),
    "v4_deeper": ("conv8", "conv9", "conv10", "text_embeds_postprocess",
                  "skip1", "skip2"),
}


def _perturb_stats(stats, rng):
    """Running statistics away from (0, 1), so eval-mode BatchNorm is not
    an identity."""
    def one(path, a):
        a = np.asarray(a)
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (0.1 * rng.randn(*a.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(one, stats)


def test_discriminator_eval_forward_matches_jax(rng):
    module = j_registry.build_discriminator(DOUT)
    variables = j_registry.init_discriminator(module, jax.random.PRNGKey(2),
                                              batch=2, T=T - 1)
    variables = jax.tree.map(np.asarray, variables)
    variables = {"params": variables["params"],
                 "batch_stats": _perturb_stats(variables["batch_stats"], rng)}
    x = rng.randn(B, DOUT, T - 1).astype(np.float32)
    ref = np.asarray(j_registry.apply_disc_bdt(module, variables, jnp.asarray(x)))

    net = t_registry.build_discriminator(DOUT, device="cpu")
    net.load_state_dict(convert.discriminator_state_dict(variables), strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (B, 1, 1)
    np.testing.assert_allclose(got, ref, atol=FWD_ATOL, rtol=0)


def test_discriminator_layout_is_the_references():
    """``convs`` indices 1, 5, ..., 25 and 29 hold the convs, 3, 7, ..., 27
    the BatchNorms, so a reference discriminator .pth loads strictly."""
    net = t_registry.build_discriminator(DOUT, device="cpu")
    keys = set(net.state_dict())
    for i in range(7):
        assert f"convs.{1 + 4 * i}.weight" in keys
        assert f"convs.{3 + 4 * i}.running_var" in keys
    assert "convs.29.bias" in keys
    assert net.convs[29].weight.shape == (1, 8, 3)
    a = t_registry.build_discriminator(DOUT, seed=5, device="cpu").state_dict()
    b = t_registry.build_discriminator(DOUT, seed=5, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_build_discriminator_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        t_registry.build_discriminator(DOUT)
    with pytest.raises(RuntimeError):
        t_gan.GanTrainer(t_gan.GanConfig())


def test_calc_motion_matches_jax(rng):
    y = rng.randn(3, T, DOUT).astype(np.float32)
    ref = np.asarray(j_gan.calc_motion(jnp.asarray(y)))  # (B, T-1, D)
    got = t_gan.calc_motion(torch.from_numpy(y).transpose(1, 2))  # (B, D, T-1)
    np.testing.assert_array_equal(got.transpose(1, 2).numpy(), ref)
    # first frame minus each of the first T-1 frames, not adjacent deltas
    np.testing.assert_array_equal(ref[:, 5], y[:, 0] - y[:, 5])


def _cfg(mod, loss, smooth, model="v1", cond=None):
    """``cond``: None, "text" or "image"."""
    return mod.GanConfig(
        model=model, feature_in_dim=DIN, feature_out_dim=DOUT, default_size=SIZE,
        window_t=T, batch_size=B, loss=loss, learning_rate=LR,
        dropout_rate=0.0, disc_label_smooth=smooth,
        require_text=cond == "text", require_image=cond == "image",
    )


class _Pair:
    """The JAX trainer with its initial state, and a way to make a port
    trainer holding the same weights."""

    def __init__(self, loss, smooth, model="v1", cond=None):
        rng = np.random.RandomState(7)
        self.loss, self.smooth, self.model, self.cond = loss, smooth, model, cond
        # the D step whose float32 noise outgrows the fixed mask
        self.d_noise_rel = NOISE_REL if (model, cond) == ("v4", "text") else 0.0
        self.jax = j_gan.GanTrainer(_cfg(j_gan, loss, smooth, model, cond))
        state = self.jax.init_state()
        state["g_stats"] = _perturb_stats(state["g_stats"], rng)
        state["d_stats"] = _perturb_stats(state["d_stats"], rng)
        state.pop("rng")
        self.state0 = jax.tree.map(np.asarray, state)
        self.x = rng.randn(B, T, DIN).astype(np.float32)
        self.y = rng.randn(B, T, DOUT).astype(np.float32)
        self.feats = None
        if cond is not None:
            shape = (B, 512) if cond == "text" else (B, T, 2000)
            self.feats = rng.randn(*shape).astype(np.float32)

    def jax_args(self):
        return (jnp.asarray(self.x), jnp.asarray(self.y),
                None if self.feats is None else jnp.asarray(self.feats))

    def port_args(self):
        return (torch.from_numpy(self.x), torch.from_numpy(self.y),
                None if self.feats is None else torch.from_numpy(self.feats))

    def jax_state(self):
        # the jitted steps donate their state: hand each a fresh copy
        state = jax.tree.map(jnp.asarray, self.state0)
        # dropout is off, so the key's value does not matter
        state["rng"] = jax.random.key(0, impl=self.jax.cfg.prng_impl)
        return state

    def port(self):
        tr = t_gan.GanTrainer(_cfg(t_gan, self.loss, self.smooth, self.model,
                                   self.cond), device="cpu")
        s = self.state0
        tr.generator.load_state_dict(convert.generator_state_dict(
            {"params": s["g_params"], "batch_stats": s["g_stats"]}), strict=True)
        tr.discriminator.load_state_dict(convert.discriminator_state_dict(
            {"params": s["d_params"], "batch_stats": s["d_stats"]}), strict=True)
        if tr.adaptive is not None:
            tr.adaptive.load_state_dict(convert.robust_state_dict(s["robust"]),
                                        strict=True)
        return tr


@pytest.fixture(scope="module", params=[
    ("RobustLoss", True), ("L1", True), ("RobustLoss", False),
    ("RobustLoss", True, "v2", "text"), ("RobustLoss", True, "v4", "text"),
    ("RobustLoss", True, "v4_deeper", "text"), ("RobustLoss", True, "b2h", "image"),
], ids=["robust-smooth", "l1-smooth", "robust", "v2-text", "v4-text",
        "v4_deeper-text", "b2h-image"])
def pair(request):
    return _Pair(*request.param)


def _hold_state(module, want_sd, noise_rel=0.0):
    """Post-step state_dict against the JAX one: parameters outside the
    gradient-noise mask (0 < |g| < NOISE, or below ``noise_rel`` of the
    tensor's largest |g|) and every running statistic within STEP_ATOL,
    masked entries within 2 * LR + STEP_ATOL (a parameter the loss does
    not reach has no gradient and is held whole); returns the masked
    share."""
    grads = {k: p.grad.abs() for k, p in module.named_parameters()
             if p.grad is not None}
    masked = total = 0
    for k, v in module.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue  # no JAX counterpart
        diff = (v - want_sd[k]).abs()
        if k in grads:
            g = grads[k]
            keep = (g == 0) | (g >= max(NOISE, noise_rel * float(g.max())))
            masked += int((~keep).sum())
            total += keep.numel()
            inside = float((diff * ~keep).max())
            assert inside <= 2 * LR + STEP_ATOL, (k, inside)
            diff = diff * keep
        assert float(diff.max()) <= STEP_ATOL, (k, float(diff.max()))
    return masked / total


def test_g_step_matches_jax(pair):
    st1, j_loss = pair.jax._g_step(pair.jax_state(), *pair.jax_args())
    st1 = jax.tree.map(np.asarray, {k: v for k, v in st1.items() if k != "rng"})
    tr = pair.port()
    d_before = copy.deepcopy(tr.discriminator.state_dict())
    g_before = copy.deepcopy(tr.generator.state_dict())
    latents = copy.deepcopy(tr.adaptive.state_dict()) if tr.adaptive else {}
    loss = tr.g_step(*pair.port_args())
    assert abs(float(loss) - float(j_loss)) <= STEP_ATOL * max(1.0, abs(float(j_loss)))
    share = _hold_state(tr.generator, convert.generator_state_dict(
        {"params": st1["g_params"], "batch_stats": st1["g_stats"]}))
    assert share <= MASKED_SHARE
    # the branches that cannot reach the output ran in train mode: their
    # statistics moved, and _hold_state held them to the JAX package's
    for name in DEAD_BRANCHES.get(pair.model, ()):
        key = f"{name}.3.running_mean"
        assert not torch.equal(tr.generator.state_dict()[key], g_before[key]), key
    # the G step leaves D (in eval mode: statistics too) and the latents alone
    for k, v in tr.discriminator.state_dict().items():
        assert torch.equal(v, d_before[k]), k
    if tr.adaptive is not None:
        for k, v in tr.adaptive.state_dict().items():
            assert torch.equal(v, latents[k]), k
            np.testing.assert_array_equal(v.numpy(), st1["robust"][k])
        assert all(p.grad is None for p in tr.adaptive.parameters())


def test_d_step_matches_jax(pair):
    st1, j_loss = pair.jax._d_step(pair.jax_state(), *pair.jax_args())
    st1 = jax.tree.map(np.asarray, {k: v for k, v in st1.items() if k != "rng"})
    tr = pair.port()
    g_before = copy.deepcopy(tr.generator.state_dict())
    loss = tr.d_step(*pair.port_args())
    assert abs(float(loss) - float(j_loss)) <= STEP_ATOL * max(1.0, abs(float(j_loss)))
    share = _hold_state(tr.discriminator, convert.discriminator_state_dict(
        {"params": st1["d_params"], "batch_stats": st1["d_stats"]}), pair.d_noise_rel)
    assert share <= MASKED_SHARE
    # two train-mode forwards: the statistics moved twice
    assert int(tr.discriminator.convs[3].num_batches_tracked) == 2
    for k, v in tr.generator.state_dict().items():  # G in eval mode, untouched
        assert torch.equal(v, g_before[k]), k


def test_val_step_matches_jax(pair):
    j_loss = pair.jax._val_step(pair.jax_state(), *pair.jax_args())
    tr = pair.port()
    loss = tr.val_step(*pair.port_args())
    assert abs(float(loss) - float(j_loss)) <= STEP_ATOL * max(1.0, abs(float(j_loss)))
    assert not any(p.grad is not None for p in tr.generator.parameters())


@pytest.mark.parametrize("kind", ["g", "d", "val"])
def test_steps_run_without_cudnn_or_tf32_and_restore_them(monkeypatch, kind):
    """Every step runs its convolutions with cuDNN off and TF32 off, and
    puts both switches back afterwards, also when the step raises."""
    tr = _Pair("RobustLoss", True).port()
    args = (torch.from_numpy(np.zeros((B, T, DIN), np.float32)),
            torch.from_numpy(np.zeros((B, T, DOUT), np.float32)))
    seen = []
    forward = tr.generator.forward

    def spy(*a, **k):
        seen.append((torch.backends.cudnn.enabled, torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return forward(*a, **k)

    monkeypatch.setattr(torch.backends.cudnn, "enabled", True)
    monkeypatch.setattr(tr.generator, "forward", spy)
    tr._step(kind)(*args)
    assert seen == [(False, False, False)]
    assert torch.backends.cudnn.enabled

    def fail(*a, **k):
        raise RuntimeError("inside the step")

    monkeypatch.setattr(tr.generator, "forward", fail)
    with pytest.raises(RuntimeError, match="inside the step"):
        tr._step(kind)(*args)
    assert torch.backends.cudnn.enabled


def test_robust_residual_columns_follow_the_jax_order(rng):
    """Column j of the flattened residual is t * Dout + d, as in the JAX
    package: with per-column latents that differ, the loss still agrees."""
    p = _Pair("RobustLoss", False)
    p.state0["robust"] = {k: (v + rng.randn(*v.shape)).astype(np.float32)
                          for k, v in p.state0["robust"].items()}
    j_loss = p.jax._val_step(p.jax_state(), jnp.asarray(p.x), jnp.asarray(p.y), None)
    loss = p.port().val_step(torch.from_numpy(p.x), torch.from_numpy(p.y))
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)


def test_epoch_loops_agree_and_drop_the_partial_batch(rng):
    """run_epoch (host batches) and run_epoch_resident (staged data, a
    permutation) take the same steps; 2 full batches of 8 from 19 rows."""
    X = rng.randn(19, T, DIN).astype(np.float32)
    Y = rng.randn(19, T, DOUT).astype(np.float32)
    perm = np.random.RandomState(1).permutation(19)
    a = t_gan.GanTrainer(_cfg(t_gan, "RobustLoss", True), device="cpu")
    b = t_gan.GanTrainer(_cfg(t_gan, "RobustLoss", True), device="cpu")
    staged = b.stage(X, Y)
    for kind in ("g", "d", "val"):
        la = a.run_epoch(X[perm], Y[perm], kind, B)
        lb = b.run_epoch_resident(*staged, perm, kind, B)
        assert np.isfinite(la) and la == lb, (kind, la, lb)
    for k, v in a.generator.state_dict().items():
        assert torch.equal(v, b.generator.state_dict()[k]), k
    assert int(a.generator.encoder[3].num_batches_tracked) == 2
    assert a.run_epoch(X[:5], Y[:5], "g", B) == 0.0
    assert b.run_epoch_resident(X[:5], Y[:5], np.arange(5), "val", B) == 0.0


def test_dropout_comes_from_the_trainers_generator(rng):
    """With dropout on, two trainers of one seed take the same step and the
    global generator is not consumed; another seed takes another."""
    x = torch.from_numpy(rng.randn(B, T, DIN).astype(np.float32))
    y = torch.from_numpy(rng.randn(B, T, DOUT).astype(np.float32))

    def one(seed):
        cfg = _cfg(t_gan, "L1", False)
        cfg.dropout_rate, cfg.seed = 0.5, seed
        tr = t_gan.GanTrainer(cfg, device="cpu")
        return float(tr.g_step(x, y)), float(tr.d_step(x, y))

    before = torch.get_rng_state()
    first = one(3)
    assert torch.equal(torch.get_rng_state(), before)
    assert one(3) == first
    other = one(4)
    assert other != first


@pytest.mark.parametrize("field", ["prng_impl"])
def test_config_has_no_field_of_an_unported_feature(field):
    """A feature without a counterpart has no field; the CLI refuses its
    flag (tests/test_torch_train_cli.py)."""
    with pytest.raises(TypeError):
        t_gan.GanConfig(**{field: True})
