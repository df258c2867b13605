"""The lifting's initialisation along the bone tree: hand-written Hopper kernel +
plain version.

Replaces no Pallas kernel: it stands for the JAX package's XLA-compiled
``lax.scan`` over the bones (``lifting/init3d.py: initialization`` and
``lifting/filtering.py: fk_from_angles``), which eager PyTorch runs as ~15K
small launches a batch.  Inputs: the normalised, pruned, masked 2D planes
``Xx``, ``Xy`` (B, T, 50), the per-clip bone lengths (B, 49)
(``init3d.bone_lengths``) and the noisy roots ``rootsx``, ``rootsy``,
``rootsz`` (B, T) (``init3d.roots``), all float32; returns the forward
kinematics of the initial estimate, x0, y0, z0 (B, T, 50), as
``engine._init_core`` hands them to the filter.

* ``lift_init``: the wrapper.  A CPU tensor runs ``lift_init_plain``; a
  CUDA tensor launches ``csrc/lift_init.cu`` (built at first use by
  ``ops/build.py``) or raises.  ``lift_init.launches`` counts launches, and
  the tracer counts ``lift.init_kernel`` once a batch that takes the kernel.
* ``lift_init_plain``: ``init3d.walk_bones`` then
  ``filtering.forward_kinematics``, the code the JAX package is held to.

The kernel gives the plain version's numbers bit for bit: one thread per
(clip, frame) runs the 49 bones in order with the plain op stream's IEEE
roundings (see the note in the CUDA source).  It is bound by instruction
issue (correctly rounded divisions and square roots, several instructions
each) more than by its ``BYTES_PER_FRAME`` or its ``FLOPS_PER_FRAME``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.lifting import (
    filtering,
    init3d,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops import build, skeleton
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.profiling import count

J = skeleton.N_JOINTS
# Xx and Xy read, x0, y0 and z0 written, the three roots read (the bone
# lengths, 196 B a clip, come on top)
BYTES_PER_FRAME = 5 * J * 4 + 3 * 4
# a bone's operations, a division or square root counted as one: compute_b
# 164 (its five reprojection errors 90 of them), the guards and the
# normalisation 11, the anchor 6, forward kinematics 16
FLOPS_PER_FRAME = skeleton.N_BONES * (164 + 11 + 6 + 16)
# bone i runs from joint BONE_START[i] to joint i + 1, so walking the bones in
# order visits every start joint after it is placed
assert np.all(skeleton.BONE_END == np.arange(1, J)) and np.all(
    skeleton.BONE_START < skeleton.BONE_END)
_BONE_START = (ctypes.c_int * skeleton.N_BONES)(*(int(a) for a in skeleton.BONE_START))


def lift_init_plain(Xx, Xy, L_per_bone, rootsx, rootsy, rootsz):
    """The walk along the tree and its forward kinematics, in PyTorch."""
    gx, gy, gz, _, _, _ = init3d.walk_bones(Xx, Xy, L_per_bone, rootsx, rootsy, rootsz)
    return filtering.forward_kinematics(L_per_bone, rootsx, rootsy, rootsz, gx, gy, gz)


def _check(tensors, names, B, T):
    for t, n in zip(tensors, names):
        if t.device.type != "cuda" or t.device != tensors[0].device:
            raise ValueError(f"lift_init: {n} is on {t.device}; the kernel takes "
                             f"CUDA tensors on one device ({tensors[0].device})")
        if t.dtype != torch.float32:
            raise ValueError(f"lift_init: {n} must be float32, got {t.dtype}")
        want = {"L_per_bone": (B, J - 1), "rootsx": (B, T), "rootsy": (B, T),
                "rootsz": (B, T)}.get(n, (B, T, J))
        if tuple(t.shape) != want:
            raise ValueError(f"lift_init: {n} has shape {tuple(t.shape)}, want {want}")
        if not t.is_contiguous():
            raise ValueError(f"lift_init: {n} must be contiguous")


def lift_init_kernel(Xx, Xy, L_per_bone, rootsx, rootsy, rootsz):
    """The CUDA kernel on CUDA tensors; raises on anything else."""
    B, T = Xx.shape[:2]
    ins = (Xx, Xy, L_per_bone, rootsx, rootsy, rootsz)
    _check(ins, ("Xx", "Xy", "L_per_bone", "rootsx", "rootsy", "rootsz"), B, T)
    outs = tuple(torch.empty_like(Xx) for _ in range(3))
    if B == 0 or T == 0:
        return outs
    fn = build.bind("lift_init", "mhpe_lift_init", [ctypes.c_void_p] * 9 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    build.launch(fn, Xx.device, *(t.data_ptr() for t in ins + outs), B, T,
                 ctypes.cast(_BONE_START, ctypes.c_void_p))
    lift_init.launches += 1
    return outs


def lift_init(Xx, Xy, L_per_bone, rootsx, rootsy, rootsz):
    """x0, y0, z0 of a batch: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if Xx.device.type == "cpu":
        return lift_init_plain(Xx, Xy, L_per_bone, rootsx, rootsy, rootsz)
    if Xx.device.type != "cuda":
        raise ValueError(f"lift_init: unsupported device {Xx.device}")
    out = lift_init_kernel(*(t.contiguous() for t in (
        Xx, Xy, L_per_bone, rootsx, rootsy, rootsz)))
    count("lift.init_kernel")
    return out


lift_init.launches = 0
