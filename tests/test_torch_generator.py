"""Port's v1 generator and weights bridge against the JAX package.

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
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models import (
    convert,
    generators as t_generators,
    registry as t_registry,
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


def test_unported_generator_raises():
    with pytest.raises(NotImplementedError):
        t_registry.build_generator("v2", 12, 8, device="cpu")
