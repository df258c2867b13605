"""The port's robust loss (plain version, on the CPU) against the JAX package.

Same numpy-seeded inputs through the JAX functions and the port's:
``ops/robust_loss.robust_lossfun`` against ``pallas_kernels.lossfun_pallas``
in interpret mode and against ``losses.robust.general.lossfun``; the
partition function, ``nllfun`` and ``AdaptiveLossFunction``.

Tolerances are the JAX package's own for its Pallas kernel
(tests/test_pallas_kernels.py:108 and :122): loss rtol 1e-5 / atol 1e-6,
gradients rtol 1e-4 / atol 1e-6.  The partition function, NLL and adaptive
loss are held at rtol 1e-5 (atol 1e-6), the accuracy of the spline itself.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_hand_pose_enhancement_for_sign_language_tpu.losses import (
    robust as j_robust,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu.losses.robust import (
    general as j_general,
    util as j_util,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu.ops import pallas_kernels
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch import losses as t_losses
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.losses import (
    robust as t_robust,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.losses.robust import (
    general as t_general,
    util as t_util,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models import convert
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops import (
    robust_loss as rl,
)

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _torch_grads(x, alpha, scale):
    xs = [torch.from_numpy(a).requires_grad_(True) for a in (x, alpha, scale)]
    loss = rl.robust_lossfun(*xs)
    loss.sum().backward()
    return loss.detach().numpy(), [t.grad.numpy() for t in xs]


@pytest.mark.parametrize("scale", [0.5, 1.0])
@pytest.mark.parametrize("alpha", [0.0, 1.0, 1.7, 2.0, 3.0])
def test_lossfun_matches_pallas_interpret_and_general(rng, alpha, scale):
    x = (rng.randn(6, 40) * 2).astype(np.float32)
    a = np.full((1, 40), alpha, np.float32)
    c = np.full((1, 40), scale, np.float32)
    got, (gx, ga, gc) = _torch_grads(x, a, c)

    pallas = pallas_kernels.lossfun_pallas(jnp.asarray(x), jnp.asarray(a),
                                           jnp.asarray(c), True)
    ref = j_general.lossfun(x, jnp.float32(alpha), jnp.float32(scale))
    np.testing.assert_allclose(got, np.asarray(pallas), **LOSS_TOL)
    np.testing.assert_allclose(got, np.asarray(ref), **LOSS_TOL)
    # scalar alpha and scale give the same as the rows
    scalar = rl.robust_lossfun(torch.from_numpy(x), alpha, scale)
    np.testing.assert_array_equal(scalar.numpy(), got)

    jx, ja, jc = jax.grad(
        lambda x_, a_, c_: jnp.sum(pallas_kernels.lossfun_pallas(x_, a_, c_, True)),
        argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(a), jnp.asarray(c))
    np.testing.assert_allclose(gx, np.asarray(jx), **GRAD_TOL)
    np.testing.assert_allclose(ga, np.asarray(ja), **GRAD_TOL)
    np.testing.assert_allclose(gc, np.asarray(jc), **GRAD_TOL)


def test_lossfun_per_column_alpha_and_scale(rng):
    D = 48
    x = (rng.randn(5, D) * 2).astype(np.float32)
    a = rng.uniform(1.0, 4.0, (1, D)).astype(np.float32)
    a[0, ::6] = 0.0
    a[0, 1::6] = 2.0
    c = rng.uniform(0.1, 3.0, (1, D)).astype(np.float32)
    got, (gx, ga, gc) = _torch_grads(x, a, c)
    want = pallas_kernels.lossfun_pallas(jnp.asarray(x), jnp.asarray(a),
                                         jnp.asarray(c), True)
    np.testing.assert_allclose(got, np.asarray(want), **LOSS_TOL)
    jx, ja, jc = jax.grad(
        lambda x_, a_, c_: jnp.sum(pallas_kernels.lossfun_pallas(x_, a_, c_, True)),
        argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(a), jnp.asarray(c))
    np.testing.assert_allclose(gx, np.asarray(jx), **GRAD_TOL)
    np.testing.assert_allclose(ga, np.asarray(ja), **GRAD_TOL)
    np.testing.assert_allclose(gc, np.asarray(jc), **GRAD_TOL)


@pytest.mark.parametrize("alpha", [-np.inf, -2.0, np.inf])
def test_general_lossfun_other_closed_forms(rng, alpha):
    """The branches only the plain version has (Welsch, Geman-McClure and
    alpha = +inf), and the approximate form."""
    x = (rng.randn(4, 10) * 2).astype(np.float32)
    got = t_general.lossfun(torch.from_numpy(x), alpha, 0.7).numpy()
    want = j_general.lossfun(x, jnp.float32(alpha), jnp.float32(0.7))
    np.testing.assert_allclose(got, np.asarray(want), **LOSS_TOL)
    if np.isfinite(alpha):
        got = t_general.lossfun(torch.from_numpy(x), alpha, 0.7, approximate=True)
        want = j_general.lossfun(x, jnp.float32(alpha), jnp.float32(0.7),
                                 approximate=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOSS_TOL)


def test_latent_gradients_only_when_asked():
    """On the CPU the wrapper is the plain version under autograd; constant
    alpha and scale get no gradient and x still does."""
    x = torch.randn(3, 8, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    a, c = torch.full((1, 8), 1.5), torch.full((1, 8), 0.7)
    rl.robust_lossfun(x, a, c).sum().backward()
    assert x.grad is not None and a.grad is None and c.grad is None
    assert rl.robust_lossfun.launches == 0  # no kernel on a CPU tensor


@pytest.mark.parametrize("name,args", [
    ("log_safe", (np.array([1e-3, 1.0, 1e38], np.float32),)),
    ("log1p_safe", (np.array([1e-3, 1.0, 1e38], np.float32),)),
    ("exp_safe", (np.array([-3.0, 1.0, 100.0], np.float32),)),
    ("expm1_safe", (np.array([-3.0, 1e-4, 100.0], np.float32),)),
    ("inv_softplus", (np.array([0.1, 1.0, 90.0], np.float32),)),
    ("logit", (np.array([0.1, 0.5, 0.9], np.float32),)),
    ("affine_sigmoid", (np.array([-2.0, 0.0, 3.0], np.float32), 1.0, 4.0)),
    ("inv_affine_sigmoid", (np.array([1.5, 2.0, 3.9], np.float32), 1.0, 4.0)),
    ("affine_softplus", (np.array([-2.0, 0.0, 3.0], np.float32), 1e-5, 0.5)),
    ("inv_affine_softplus", (np.array([0.1, 0.5, 3.0], np.float32), 1e-5, 0.5)),
    ("students_t_nll", (np.array([-1.0, 0.3, 2.0], np.float32),
                        np.float32(3.0), np.float32(0.7))),
])
def test_util_matches_jax(name, args):
    t_args = [torch.from_numpy(np.asarray(a)) if isinstance(a, np.ndarray)
              or isinstance(a, np.floating) else a for a in args]
    got = getattr(t_util, name)(*t_args).numpy()
    want = np.asarray(getattr(j_util, name)(*args))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_log_partition_and_spline_curves(rng):
    alpha = np.concatenate([np.linspace(0.0, 4.0, 41), [5.0, 10.0, 100.0],
                            rng.uniform(0, 8, 20)]).astype(np.float32)
    jd, td = j_robust.Distribution(), t_robust.Distribution()
    got = td.log_base_partition_function(torch.from_numpy(alpha)).numpy()
    want = np.asarray(jd.log_base_partition_function(alpha))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    from multimodal_hand_pose_enhancement_for_sign_language_tpu.losses.robust import (
        distribution as j_dist,
    )
    from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.losses.robust import (
        distribution as t_dist,
    )
    curve = t_dist.partition_spline_curve(torch.from_numpy(alpha))
    np.testing.assert_allclose(curve.numpy(),
                               np.asarray(j_dist.partition_spline_curve(alpha)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        t_dist.inv_partition_spline_curve(curve).numpy(),
        np.asarray(j_dist.inv_partition_spline_curve(curve.numpy())),
        rtol=1e-5, atol=1e-5)
    assert list(td.state_dict()) == []  # the spline is not checkpointed


def test_nllfun_matches_jax(rng):
    x = (rng.randn(5, 30) * 2).astype(np.float32)
    a = rng.uniform(0.0, 4.0, (1, 30)).astype(np.float32)
    c = rng.uniform(0.1, 3.0, (1, 30)).astype(np.float32)
    got = t_robust.Distribution().nllfun(*(torch.from_numpy(v) for v in (x, a, c)))
    want = j_robust.Distribution().nllfun(x, a, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_draw_samples_follow_the_distribution():
    """Distributional check (the two packages' random streams differ):
    alpha = 2, c = 1 is a unit normal; alpha = 0 a Cauchy of scale sqrt 2."""
    gen = torch.Generator().manual_seed(3)
    n = 20000
    s = t_robust.Distribution().draw_samples(gen, torch.full((n,), 2.0),
                                             torch.ones(n))
    assert abs(float(s.mean())) < 0.03 and abs(float(s.std()) - 1.0) < 0.03
    s = t_robust.Distribution().draw_samples(gen, torch.zeros(n), torch.ones(n))
    q = float(s.abs().median())  # the half-width of a Cauchy is its scale
    assert abs(q - np.sqrt(2.0)) < 0.05


def test_adaptive_default_latents_are_exactly_two_and_half():
    D = 64
    t_ad = t_robust.AdaptiveLossFunction(D)
    j_ad = j_robust.AdaptiveLossFunction(D)
    j_params = jax.tree.map(np.asarray, j_ad.init())
    sd = convert.robust_state_dict(j_params)
    for k, v in t_ad.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy())
    assert bool((t_ad.alpha() == 2.0).all())
    assert bool((t_ad.scale() == 0.5).all())
    assert np.all(np.asarray(j_ad.alpha(j_params)) == 2.0)
    assert np.all(np.asarray(j_ad.scale(j_params)) == 0.5)


@pytest.mark.parametrize("perturbed", [False, True])
def test_adaptive_lossfun_matches_jax(rng, perturbed):
    D = 40
    x = (rng.randn(6, D) * 2).astype(np.float32)
    j_ad = j_robust.AdaptiveLossFunction(D)
    params = jax.tree.map(np.asarray, j_ad.init())
    if perturbed:
        params = {k: (v + rng.randn(*v.shape)).astype(np.float32)
                  for k, v in params.items()}
    t_ad = t_robust.AdaptiveLossFunction(D)
    t_ad.load_state_dict(convert.robust_state_dict(params), strict=True)
    np.testing.assert_allclose(t_ad.alpha().detach().numpy(),
                               np.asarray(j_ad.alpha(params)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_ad.scale().detach().numpy(),
                               np.asarray(j_ad.scale(params)), rtol=1e-5, atol=1e-6)
    got = t_ad.lossfun(torch.from_numpy(x)).detach().numpy()
    want = np.asarray(j_ad.lossfun(jnp.asarray(x), params))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the latents are parameters, and their gradients agree with JAX's
    t_ad.lossfun(torch.from_numpy(x)).sum().backward()
    grads = jax.grad(lambda p: jnp.sum(j_ad.lossfun(jnp.asarray(x), p)))(params)
    np.testing.assert_allclose(t_ad.latent_alpha.grad.numpy(),
                               np.asarray(grads["latent_alpha"]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t_ad.latent_scale.grad.numpy(),
                               np.asarray(grads["latent_scale"]), rtol=1e-4, atol=1e-5)


def test_adaptive_rejects_bad_ranges():
    with pytest.raises(ValueError):
        t_robust.AdaptiveLossFunction(4, alpha_lo=-1.0)
    with pytest.raises(ValueError):
        t_robust.AdaptiveLossFunction(4, alpha_init=5.0)
    with pytest.raises(ValueError):
        t_robust.AdaptiveLossFunction(4, scale_lo=0.0)
    fixed = t_robust.AdaptiveLossFunction(4, alpha_lo=2.0, alpha_hi=2.0,
                                          scale_lo=0.5, scale_init=0.5)
    assert list(fixed.state_dict()) == []
    assert bool((fixed.alpha() == 2.0).all()) and bool((fixed.scale() == 0.5).all())


@pytest.mark.parametrize("name", ["L1", "L2", "Huber1"])
def test_basic_losses_match_jax(rng, name):
    from multimodal_hand_pose_enhancement_for_sign_language_tpu import losses as j_losses

    p = (rng.randn(4, 7, 5) * 2).astype(np.float32)
    t = rng.randn(4, 7, 5).astype(np.float32)
    got = t_losses.get_loss(name)(torch.from_numpy(p), torch.from_numpy(t))
    want = j_losses.get_loss(name)(jnp.asarray(p), jnp.asarray(t))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    with pytest.raises(KeyError):
        t_losses.get_loss("nope")
