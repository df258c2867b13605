"""Port's lifting filter (ops/filter_sgd) against the JAX package.

On the CPU the port's wrapper runs its plain PyTorch version; it is held
against the JAX ``filtering.filter_xyz`` loop and the Pallas
``filter_sgd`` kernel in interpret mode, both as
tests/test_pallas_kernels.py runs them.  Tolerance: atol 2e-4, the JAX
package's own Pallas-vs-XLA filter tolerance (test_pallas_kernels.py:44).
The CUDA kernel itself is compared with the plain version on the card by
chip_smoke.py (no CUDA compiler or device here).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multimodal_hand_pose_enhancement_for_sign_language_tpu.lifting import filtering
from multimodal_hand_pose_enhancement_for_sign_language_tpu.ops import pallas_kernels
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.lifting import (
    filtering as t_filtering,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops import (
    filter_sgd as t_filter,
)

ATOL = 2e-4  # test_pallas_kernels.py:44
LR = 20.0


def _filter_inputs(rng, B, T):
    planes = [rng.randn(B, T, 50).astype(np.float32) for _ in range(5)]
    w = rng.rand(B, T, 50).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[1, 2 * T // 3 :] = 0.0  # one short (masked) clip
    w = w * mask[:, :, None]
    return (*planes, w, mask)


def _port(inputs, n_cycles):
    return [
        o.numpy()
        for o in t_filter.filter_sgd(
            *(torch.from_numpy(a) for a in inputs), LR, n_cycles
        )
    ]


def _jax_loop(inputs, n_cycles):
    x0, y0, z0, tarx, tary, w, mask = inputs
    outs = [
        filtering.filter_xyz(
            x0[b], y0[b], z0[b], tarx[b], tary[b], w[b],
            learning_rate=LR, n_cycles=n_cycles, mask=mask[b],
        )
        for b in range(x0.shape[0])
    ]
    return [np.stack([np.asarray(o[k]) for o in outs]) for k in range(3)]


@pytest.mark.parametrize(
    "B,T,n_cycles",
    [(3, 40, 1), (3, 40, 2), (3, 40, 25), (3, 40, 57), (5, 16, 25), (2, 64, 900)],
)
def test_plain_filter_matches_jax_filter_xyz(rng, B, T, n_cycles):
    inputs = _filter_inputs(rng, B, T)
    for ours, ref in zip(_port(inputs, n_cycles), _jax_loop(inputs, n_cycles)):
        np.testing.assert_allclose(ours, ref, atol=ATOL)


@pytest.mark.parametrize("B,T", [(3, 40), (5, 16)])
def test_plain_filter_matches_pallas_interpret(rng, B, T):
    inputs = _filter_inputs(rng, B, T)
    ref = pallas_kernels.filter_sgd(
        *(jnp.asarray(a) for a in inputs), LR, 25, interpret=True
    )
    for ours, r in zip(_port(inputs, 25), ref):
        np.testing.assert_allclose(ours, np.asarray(r), atol=ATOL)


def test_cpu_tensor_never_launches_the_kernel(rng):
    inputs = _filter_inputs(rng, 2, 16)
    before = t_filter.filter_sgd.launches
    _port(inputs, 3)
    assert t_filter.filter_sgd.launches == before == 0


def test_filtering_filter_xyz_is_the_plain_loop(rng):
    """The port's lifting/filtering.filter_xyz (no mask: every frame valid)
    is the same loop as the JAX filter_xyz."""
    x0, y0, z0, tarx, tary, w, _ = _filter_inputs(rng, 2, 12)
    ours = t_filtering.filter_xyz(
        *(torch.from_numpy(a) for a in (x0, y0, z0, tarx, tary, w)),
        learning_rate=LR, n_cycles=30,
    )
    for b in range(2):
        ref = filtering.filter_xyz(x0[b], y0[b], z0[b], tarx[b], tary[b], w[b],
                                   learning_rate=LR, n_cycles=30)
        for o, r in zip(ours, ref):
            np.testing.assert_allclose(o[b].numpy(), np.asarray(r), atol=ATOL)


def test_wrapper_raises_off_cpu_without_a_kernel():
    """A tensor that is neither on the CPU nor on CUDA is refused, not
    routed to the plain version."""
    planes = [torch.zeros(2, 8, 50, device="meta") for _ in range(6)]
    with pytest.raises(ValueError):
        t_filter.filter_sgd(*planes, torch.zeros(2, 8, device="meta"), LR, 3)


@pytest.mark.parametrize("B,T,n_cycles", [(3, 40, 25), (5, 16, 900)])
def test_plain_filter_leaves_masked_tails_at_x0(rng, B, T, n_cycles):
    """Masked steps are exact fixed points of the plain loop (wm = 0 and
    pair = 0 there), so a masked tail comes out as x0 bit for bit: the
    property that lets the CUDA kernel skip warps that hold only such
    steps."""
    inputs = _filter_inputs(rng, B, T)
    masked = inputs[6] == 0
    assert masked.any() and not masked.all()
    for out, x0 in zip(_port(inputs, n_cycles), inputs[:3]):
        np.testing.assert_array_equal(out[masked], x0[masked])
        assert not np.array_equal(out[~masked], x0[~masked])
