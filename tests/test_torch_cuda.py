"""The port's CUDA kernels on the card (marked ``cuda``; skipped without
one), and the host-side choice of kernel template, which runs anywhere.

This file imports torch and the port only, so it runs on a machine without
JAX.  There, skip the JAX-only conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances, each against the kernel's plain PyTorch version and each the
JAX package's own for its Pallas kernel: the filter atol 2e-4
(test_pallas_kernels.py:44); the robust loss rtol 1e-5 / atol 1e-6, its dx
rtol 1e-4 / atol 1e-6 (test_pallas_kernels.py:108, :122).
"""

import numpy as np
import pytest
import torch

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops import (
    filter_sgd as fs,
    robust_loss as rl,
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


def _robust_inputs(N, D, device, seed=0):
    """x ~ N(0, 2); per-column alpha exactly 0, exactly 2 and spread over
    (1, 4); c spread over (1e-3, 3)."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(N, D) * 2).astype(np.float32)
    alpha = rng.uniform(1.0, 4.0, (1, D)).astype(np.float32)
    alpha[0, ::5] = 0.0
    alpha[0, 1::5] = 2.0
    c = rng.uniform(1e-3, 3.0, (1, D)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (x, alpha, c)]


def test_robust_kernel_entry_refuses_a_cpu_tensor():
    """The kernel's entry point never runs the plain version in its place
    (checked without a card); the wrapper does, for a CPU tensor only."""
    x, alpha, c = _robust_inputs(3, 10, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        rl.robust_loss_and_dx(x, alpha, c)
    before = rl.robust_lossfun.launches
    torch.testing.assert_close(rl.robust_lossfun(x, alpha, c),
                               rl.robust_lossfun_plain(x, alpha, c), rtol=0, atol=0)
    assert rl.robust_lossfun.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("N,D", [(128, 48384), (64, 48384), (7, 1000), (1, 1),
                                 (300, 257)])
def test_robust_loss_kernel_matches_plain(cuda, N, D):
    x, alpha, c = _robust_inputs(N, D, cuda)
    before = rl.robust_lossfun.launches
    xk = x.clone().requires_grad_(True)
    loss = rl.robust_lossfun(xk, alpha, c)
    g = torch.from_numpy(np.random.RandomState(1).rand(N, D).astype(np.float32)).to(cuda)
    (gx,) = torch.autograd.grad(loss, xk, g)
    torch.cuda.synchronize()
    assert rl.robust_lossfun.launches == before + 1  # forward only: no backward kernel
    xp = x.clone().requires_grad_(True)
    want = rl.robust_lossfun_plain(xp, alpha, c)
    (want_gx,) = torch.autograd.grad(want, xp, g)
    torch.testing.assert_close(loss.detach(), want.detach(), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gx, want_gx, rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
def test_robust_loss_kernel_scalars_and_latent_gradients(cuda):
    x, alpha, c = _robust_inputs(16, 96, cuda)
    torch.testing.assert_close(rl.robust_lossfun(x, 2.0, 0.5),
                               rl.robust_lossfun_plain(x, 2.0, 0.5),
                               rtol=1e-5, atol=1e-6)
    a = alpha.clone().requires_grad_(True)
    s = c.clone().requires_grad_(True)
    ga, gs = torch.autograd.grad(rl.robust_lossfun(x, a, s).sum(), (a, s))
    wa, ws = torch.autograd.grad(rl.robust_lossfun_plain(x, a, s).sum(), (a, s))
    torch.testing.assert_close(ga, wa, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(gs, ws, rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
def test_robust_loss_kernel_refuses_bad_input(cuda):
    x, alpha, c = _robust_inputs(4, 12, cuda)
    with pytest.raises(ValueError, match="float32"):
        rl.robust_lossfun(x.double(), alpha, c)
    with pytest.raises(ValueError, match="float32"):
        rl.robust_lossfun(x, alpha.double(), c)
    with pytest.raises(ValueError, match="is on"):
        rl.robust_lossfun(x, alpha.cpu(), c)
    with pytest.raises(ValueError, match="broadcast"):
        rl.robust_lossfun(x, alpha.expand(4, 12), c)
    with pytest.raises(ValueError, match="broadcast"):
        rl.robust_lossfun(x, alpha, c[:, :5])
    with pytest.raises(ValueError, match=r"\(N, D\)"):
        rl.robust_lossfun(x[0], alpha, c)
