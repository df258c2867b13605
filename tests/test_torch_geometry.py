"""Port's geometry ops (rotations, kinematics, batching) against the JAX package.

Tolerances are the JAX package's own for the same functions:
rot6d -> aa plane form 1e-5 (test_rotations.py:113), aa -> rot6d 1e-6
(test_rotations.py:107), near-pi/near-zero 1e-4 (test_rotations.py:40),
FK 1e-4 (test_kinematics.py:52), IK -> FK round trip 2e-3
(test_kinematics.py:64).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multimodal_hand_pose_enhancement_for_sign_language_tpu.ops import (
    kinematics,
    rotations,
    skeleton,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops import (
    kinematics as t_kin,
    rotations as t_rot,
)


def _random_r6d(rng, shape):
    return rng.randn(*shape).astype(np.float32)


def _edge_aa(rng, n):
    """Axis-angles near 0, exactly 0, near pi and exactly pi."""
    axes = rng.randn(n, 3)
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = np.concatenate([
        np.full(n // 4, 1e-7), np.zeros(n // 4),
        np.full(n // 4, np.pi - 1e-4), np.full(n - 3 * (n // 4), np.pi),
    ])
    return (axes * angles[:, None]).astype(np.float32)


def test_clip_rot6d_to_aa_matches_jax(rng):
    r6d = _random_r6d(rng, (2, 16, 42 * 6))
    ours = t_rot.clip_rot6d_to_aa(torch.from_numpy(r6d)).numpy()
    for b in range(2):
        ref = np.asarray(rotations.clip_rot6d_to_aa(jnp.asarray(r6d[b])))
        np.testing.assert_allclose(ours[b], ref, atol=1e-5)


def test_clip_aa_to_rot6d_matches_jax(rng):
    aa = rng.uniform(-2, 2, size=(3, 10, 48 * 3)).astype(np.float32)
    ours = t_rot.clip_aa_to_rot6d(torch.from_numpy(aa)).numpy()
    for b in range(3):
        ref = np.asarray(rotations.clip_aa_to_rot6d(jnp.asarray(aa[b])))
        np.testing.assert_allclose(ours[b], ref, atol=1e-6)


def test_near_zero_and_near_pi(rng):
    aa = _edge_aa(rng, 64).reshape(1, 64, 3)  # one frame, 64 "bones"
    r6d_ours = t_rot.clip_aa_to_rot6d(torch.from_numpy(aa)).numpy()
    r6d_ref = np.asarray(rotations.clip_aa_to_rot6d(jnp.asarray(aa[0])))
    np.testing.assert_allclose(r6d_ours[0], r6d_ref, atol=1e-6)
    back = t_rot.clip_rot6d_to_aa(torch.from_numpy(r6d_ours)).numpy()
    back_ref = np.asarray(rotations.clip_rot6d_to_aa(jnp.asarray(r6d_ref)))
    # at exactly pi, aa and -aa are the same rotation and neither package
    # fixes the sign: those rows are held up to it, the others as they are
    at_pi = np.arange(64) >= 3 * (64 // 4)
    b3, r3 = back[0].reshape(-1, 3), back_ref.reshape(-1, 3)
    np.testing.assert_allclose(b3[~at_pi], r3[~at_pi], atol=1e-4)
    pi_err = np.minimum(np.abs(b3 - r3).max(1), np.abs(b3 + r3).max(1))[at_pi]
    assert pi_err.max() <= 1e-4, pi_err
    # and the round trip itself, up to the axis sign flip at exactly pi
    a3, b3 = aa.reshape(-1, 3), back.reshape(-1, 3)
    err = np.minimum(np.abs(a3 - b3).max(1), np.abs(a3 + b3).max(1))
    assert err.max() <= 1e-4


def test_list_apis_match_jax_and_bucket(rng):
    clips = [_random_r6d(rng, (T, 12)) for T in (5, 64, 70)]
    ours = t_rot.rot6d_to_aa(clips, device="cpu")
    ref = rotations.rot6d_to_aa(clips)
    for o, r, c in zip(ours, ref, clips):
        assert o.shape == (c.shape[0], 6)
        np.testing.assert_allclose(o, r, atol=1e-5)
    back = t_rot.aa_to_rot6d(ours, device="cpu")
    back_ref = rotations.aa_to_rot6d(ref)
    for o, r in zip(back, back_ref):
        np.testing.assert_allclose(o, r, atol=1e-5)


def _plausible_xyz(rng, T=8):
    """A random but well-conditioned pose: FK (JAX) of random axis-angles."""
    aa = rng.uniform(0.2, 1.2, size=(T, 48 * 3)).astype(np.float32)
    root = np.array([0.0, 0.0, 0.0, 0.0, 1.0, 0.0], np.float32)
    bone_len = rng.uniform(0.5, 1.5, size=(49,)).astype(np.float32)
    return aa, root, bone_len


def test_fk_matches_jax(rng):
    aa, root, bone_len = _plausible_xyz(rng)
    ours = t_kin.clip_aa_to_xyz(*(torch.from_numpy(a) for a in (aa, root, bone_len)))
    ref = kinematics.clip_aa_to_xyz(jnp.asarray(aa), jnp.asarray(root),
                                    jnp.asarray(bone_len))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_ik_matches_jax_and_round_trips(rng):
    aa, root, bone_len = _plausible_xyz(rng)
    xyz = np.asarray(kinematics.clip_aa_to_xyz(jnp.asarray(aa), jnp.asarray(root),
                                               jnp.asarray(bone_len)))
    ours = t_kin.clip_xyz_to_aa(torch.tensor(xyz))
    ref = np.asarray(kinematics.clip_xyz_to_aa(jnp.asarray(xyz)))
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4)
    back = t_kin.clip_aa_to_xyz(ours, torch.from_numpy(root), torch.from_numpy(bone_len))
    np.testing.assert_allclose(back.numpy(), xyz, rtol=2e-3, atol=2e-3)


def test_fk_has_no_epsilon_guard():
    """A zero rotation gives NaN, as in the reference and the JAX package."""
    aa = np.zeros((1, 48 * 3), np.float32)
    root = np.array([0, 0, 0, 0, 1, 0], np.float32)
    ours = t_kin.clip_aa_to_xyz(*(torch.from_numpy(a) for a in (aa, root, np.ones(49, np.float32))))
    ref = kinematics.clip_aa_to_xyz(jnp.asarray(aa), jnp.asarray(root), jnp.ones(49))
    np.testing.assert_array_equal(np.isnan(ours.numpy()), np.isnan(np.asarray(ref)))
    assert np.isnan(ours.numpy()).any()


def test_list_fk_ik_and_stats_match_jax(rng):
    structure = skeleton.get_skeletal_model_structure()
    clips = []
    for T in (6, 70):
        aa, root, bone_len = _plausible_xyz(rng, T)
        clips.append(np.asarray(kinematics.clip_aa_to_xyz(
            jnp.asarray(aa), jnp.asarray(root), jnp.asarray(bone_len))))
    aa_ours = t_kin.xyz_to_aa(clips, device="cpu")
    aa_ref = kinematics.xyz_to_aa(clips)
    for o, r in zip(aa_ours, aa_ref):
        np.testing.assert_allclose(o, r, atol=1e-4)
    root = t_kin.get_root_bone(clips)
    np.testing.assert_array_equal(root, kinematics.get_root_bone(clips, structure))
    bl = t_kin.get_bone_length(clips)
    np.testing.assert_array_equal(bl, kinematics.get_bone_length(clips, structure))
    xyz_ours = t_kin.aa_to_xyz(aa_ours, root, bl, device="cpu")
    xyz_ref = kinematics.aa_to_xyz(aa_ref, root, bl, structure)
    for o, r in zip(xyz_ours, xyz_ref):
        assert o.shape == r.shape
        np.testing.assert_allclose(o, r, rtol=1e-4, atol=1e-4)


def test_list_apis_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        t_rot.rot6d_to_aa([np.zeros((4, 6), np.float32)])
