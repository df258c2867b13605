"""The port's CUDA kernels on the card (marked ``cuda``; skipped without
one), and the host-side choice of kernel template, which runs anywhere.

This file imports torch and the port only, so it runs on a machine without
JAX.  There, skip the JAX-only conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: atol 2e-4 against the plain PyTorch version, the JAX package's
filter tolerance (test_pallas_kernels.py:44).
"""

import numpy as np
import pytest
import torch

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops import (
    filter_sgd as fs,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(B, T, device, seed=0):
    rng = np.random.RandomState(seed)
    planes = [rng.randn(B, T, 50).astype(np.float32) for _ in range(5)]
    w = rng.rand(B, T, 50).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[1::3, T // 2 :] = 0.0
    w *= mask[:, :, None]
    return [torch.from_numpy(a).to(device) for a in (*planes, w, mask)]


# (B, T, n_cycles) -> steps per thread: every kernel template, including
# the lifting path's long buckets (B = 16 or 32 at T = 1920: 4 steps) and
# the full production batch (B = 128 at T = 1920: 8 steps)
KERNEL_CASES = {
    (3, 40, 25): 1,
    (5, 16, 4): 1,
    (2, 64, 900): 1,
    (7, 5, 900): 1,
    (33, 700, 900): 2,
    (16, 1920, 900): 4,
    (32, 1920, 900): 4,
    (128, 1920, 900): 8,
}


@pytest.mark.parametrize("B,T,n_cycles", list(KERNEL_CASES))
def test_steps_per_thread_picks_every_template(B, T, n_cycles):
    """The kernel cases below reach each of the 1-, 2-, 4- and 8-step
    templates (a host-side choice, checked without a card)."""
    assert fs.steps_per_thread(B, T) == KERNEL_CASES[(B, T, n_cycles)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,n_cycles", list(KERNEL_CASES))
def test_filter_sgd_kernel_matches_plain(cuda, B, T, n_cycles):
    ins = _inputs(B, T, cuda)
    before = fs.filter_sgd.launches
    got = fs.filter_sgd(*ins, 20.0, n_cycles)
    torch.cuda.synchronize()
    assert fs.filter_sgd.launches == before + 1
    want = fs.filter_sgd_plain(*ins, 20.0, n_cycles)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=2e-4, rtol=0)


@pytest.mark.cuda
def test_filter_sgd_kernel_refuses_bad_input(cuda):
    ins = _inputs(2, 8, cuda)
    with pytest.raises(ValueError):
        fs.filter_sgd(*ins[:6], ins[6].double(), 20.0, 3)
    with pytest.raises(ValueError):
        fs.filter_sgd(*(_inputs(2, 5000, cuda)), 20.0, 1)
