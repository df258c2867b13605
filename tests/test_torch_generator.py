"""Port's generators and weights bridge against the JAX package.

The JAX generator is initialized (random weights, randomized BatchNorm
statistics so eval-mode normalization is not an identity), its variables
go through the port's models/convert.py, and both run the eval forward on
the same (B, D, T) input.  Tolerance: 2e-4, the JAX package's recorded
generator eval-forward parity (STATUS.md:363); the forward is float32 on
the CPU in both packages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_hand_pose_enhancement_for_sign_language_tpu.models import (
    registry,
    torch_port,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu.train import (
    checkpoint as j_ckpt,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models import (
    convert,
    generators as t_generators,
    registry as t_registry,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.train import (
    checkpoint as t_ckpt,
)

ATOL = 2e-4  # STATUS.md:363


def _jax_variables(module, rng, T, feats_dim=None):
    variables = registry.init_generator(module, jax.random.PRNGKey(1), batch=2,
                                        T=T, feats_dim=feats_dim)
    variables = jax.tree.map(np.asarray, variables)
    # non-trivial running statistics
    variables["batch_stats"] = jax.tree.map(
        lambda a: (rng.uniform(0.5, 1.5, a.shape) if a.ndim else a).astype(np.float32),
        variables["batch_stats"],
    )
    return variables


@pytest.mark.parametrize(
    "din,dout,size,require_text,B,T",
    [
        (12, 8, 32, False, 3, 32),  # narrow
        (36, 252, 256, False, 2, 64),  # arm2wh at the real default_size
        (12, 8, 32, True, 2, 16),  # v1 with per-frame text conditioning
    ],
)
def test_v1_eval_forward_matches_jax(rng, din, dout, size, require_text, B, T):
    module = registry.build_generator("v1", din, dout, require_text=require_text,
                                      default_size=size)
    feats_dim = 512 if require_text else None
    variables = _jax_variables(module, rng, T, feats_dim)
    x = rng.randn(B, din, T).astype(np.float32)
    feats = rng.randn(B, 512).astype(np.float32) if require_text else None
    ref = np.asarray(registry.apply_bdt(
        module, variables, jnp.asarray(x),
        None if feats is None else jnp.asarray(feats),
    ))

    net = t_registry.build_generator("v1", din, dout, require_text=require_text,
                                     default_size=size, device="cpu")
    net.load_state_dict(convert.generator_state_dict(variables), strict=True)
    with torch.no_grad():
        ours = net(torch.from_numpy(x),
                   None if feats is None else torch.from_numpy(feats)).numpy()
    assert ours.shape == (B, dout, T)
    np.testing.assert_allclose(ours, ref, atol=ATOL)


def test_reference_key_layout_loads_strict(rng):
    """A state_dict from the JAX package's own bridge
    (torch_port.generator_to_torch_state) loads with strict=True, and the
    port's converter produces the same keys and values."""
    module = registry.build_generator("v1", 36, 252, default_size=64)
    variables = _jax_variables(module, rng, 32)
    sd = {k: torch.from_numpy(np.asarray(v))
          for k, v in torch_port.generator_to_torch_state(variables).items()}
    net = t_registry.build_generator("v1", 36, 252, default_size=64, device="cpu")
    net.load_state_dict(sd, strict=True)
    ours = convert.generator_state_dict(variables)
    assert sorted(ours) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(ours[k].numpy(), sd[k].numpy())
    assert "decoder.5.weight" in sd and "encoder.1.weight" in sd


def test_seeded_build_is_deterministic_and_torch_default():
    a = t_registry.build_generator("v1", 12, 8, default_size=16, seed=3, device="cpu")
    b = t_registry.build_generator("v1", 12, 8, default_size=16, seed=3, device="cpu")
    c = t_registry.build_generator("v1", 12, 8, default_size=16, seed=4, device="cpu")
    for k, v in a.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), b.state_dict()[k].numpy())
    assert not torch.equal(a.encoder[1].weight, c.encoder[1].weight)
    # U(-1/sqrt(fan_in), 1/sqrt(fan_in)): encoder conv fan_in = 12 * 3
    bound = 1 / np.sqrt(36)
    assert float(a.encoder[1].weight.detach().abs().max()) <= bound
    assert not a.training


def test_upsample_and_decoder_shapes():
    net = t_generators.regressor_fcn_bn_32(12, 8, default_size=16).eval()
    with torch.no_grad():
        for T in (32, 30):  # the upsample truncates odd bottleneck lengths
            assert net(torch.zeros(2, 12, T)).shape == (2, 8, T)


# (model, conditioned, feature shape per sample): each generator with and
# without its conditioning, at default_size 32 (b2h too: its conv5 declares
# the hard-coded 256 encoder channels plus the image branch's width)
CONDITIONED = [
    ("v2", False), ("v2", True), ("v4", False), ("v4", True),
    ("v4_deeper", False), ("v4_deeper", True), ("b2h", False), ("b2h", True),
]


def _cond_kwargs(model, cond):
    key = "require_image" if model == "b2h" else "require_text"
    return {key: cond}


def _feats(rng, model, cond, B, T):
    if not cond:
        return None
    shape = (B, T, 2000) if model == "b2h" else (B, 512)
    return rng.randn(*shape).astype(np.float32)


def _feats_dim(model, cond):
    if not cond:
        return None
    return 2000 if model == "b2h" else 512


@pytest.mark.parametrize("model,cond", CONDITIONED,
                         ids=[f"{m}-{'cond' if c else 'plain'}" for m, c in CONDITIONED])
def test_conditioned_eval_forward_matches_jax(rng, model, cond):
    din, dout, size, B, T = 12, 8, 32, 3, 32
    kw = _cond_kwargs(model, cond)
    module = registry.build_generator(model, din, dout, default_size=size, **kw)
    variables = _jax_variables(module, rng, T, _feats_dim(model, cond))
    x = rng.randn(B, din, T).astype(np.float32)
    feats = _feats(rng, model, cond, B, T)
    ref = np.asarray(registry.apply_bdt(
        module, variables, jnp.asarray(x),
        None if feats is None else jnp.asarray(feats)))

    net = t_registry.build_generator(model, din, dout, default_size=size,
                                     device="cpu", **kw)
    assert t_registry.needs_feats(net) == cond
    net.load_state_dict(convert.generator_state_dict(variables), strict=True)
    with torch.no_grad():
        ours = net(torch.from_numpy(x),
                   None if feats is None else torch.from_numpy(feats)).numpy()
    assert ours.shape == (B, dout, T)
    np.testing.assert_allclose(ours, ref, atol=ATOL)


@pytest.mark.parametrize("model", ["v1", "v2", "v4", "v4_deeper", "b2h"])
def test_bridge_matches_torch_port_for_every_generator(rng, model):
    """``convert.generator_state_dict`` gives the keys and values of the JAX
    package's ``torch_port.generator_to_torch_state`` for each conditioned
    generator, and the result loads into the port's with strict=True."""
    kw = _cond_kwargs(model, True)
    module = registry.build_generator(model, 36, 252, default_size=32, **kw)
    variables = _jax_variables(module, rng, 32, _feats_dim(model, True))
    want = torch_port.generator_to_torch_state(variables)
    ours = convert.generator_state_dict(variables)
    assert sorted(ours) == sorted(want)
    for k in want:
        assert ours[k].dtype == torch.from_numpy(np.asarray(want[k])).dtype, k
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(want[k]), err_msg=k)
    net = t_registry.build_generator(model, 36, 252, default_size=32, device="cpu", **kw)
    net.load_state_dict(ours, strict=True)


@pytest.mark.parametrize("model", ["v1", "v2", "v4", "v4_deeper", "b2h"])
@pytest.mark.parametrize("fmt", ["pkl", "pth"])
def test_checkpoints_of_every_generator_load_strict(rng, tmp_path, model, fmt):
    """A JAX-package ``.pkl`` (``train.checkpoint.save_checkpoint``) and a
    reference-layout ``.pth`` (``torch_port.save_torch_checkpoint``) of each
    conditioned generator load into the port's with strict=True, equal to
    the converter's output."""
    kw = _cond_kwargs(model, True)
    module = registry.build_generator(model, 36, 252, default_size=32, **kw)
    variables = _jax_variables(module, rng, 32, _feats_dim(model, True))
    path = str(tmp_path / f"experiment_checkpoint.{fmt}")
    if fmt == "pkl":
        j_ckpt.save_checkpoint(path, {"epoch": 3, "state": {
            "g_params": variables["params"], "g_stats": variables["batch_stats"]}})
    else:
        torch_port.save_torch_checkpoint(
            path, torch_port.generator_to_torch_state(variables), epoch=3)
    sd = t_ckpt.load_generator_state(path)
    net = t_registry.build_generator(model, 36, 252, default_size=32, device="cpu", **kw)
    net.load_state_dict(sd, strict=True)
    want = convert.generator_state_dict(variables)
    for k, v in net.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)


def test_text_cannot_reach_v2_or_v4_deepers_output(rng):
    """A property of the reference that the port keeps: at T=192 the text's
    bottleneck step of v2 is cut by the upsample and v4_deeper's text enters
    only its dead branch, so two texts give the same output; v4's differ."""
    x = torch.from_numpy(rng.randn(2, 12, 192).astype(np.float32))
    a, b = (torch.from_numpy(rng.randn(2, 512).astype(np.float32)) for _ in range(2))
    for model, reaches in (("v2", False), ("v4_deeper", False), ("v4", True)):
        net = t_registry.build_generator(model, 12, 8, require_text=True,
                                         default_size=16, device="cpu")
        with torch.no_grad():
            diff = float((net(x, a) - net(x, b)).abs().max())
        assert (diff > 0) == reaches, (model, diff)
