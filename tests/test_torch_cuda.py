"""The port's CUDA kernels on the card (marked ``cuda``; skipped without
one), and the host-side launch plans, which run anywhere.

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


def _inputs(B, T, device, seed=0, live=None):
    """Random planes; every third live clip has a masked tail, and the rows
    from ``live`` on are all-masked, as the pow2 padding of a batch."""
    rng = np.random.RandomState(seed)
    planes = [rng.randn(B, T, 50).astype(np.float32) for _ in range(5)]
    w = rng.rand(B, T, 50).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[1::3, T // 2 :] = 0.0
    mask[B if live is None else live :] = 0.0
    w *= mask[:, :, None]
    return [torch.from_numpy(a).to(device) for a in (*planes, w, mask)]


# (B, T, n_cycles) -> launch plan (K, L, W, R): rows in L < 32 lanes (down to
# one lane), rows of exactly one warp (T = 32 K = 256), and rows of W > 1
# warps of 30 K owned steps (T = 32 K + 1 up to 4096, and either side of
# 30 K W); with the lifting path's B = 16 / 32 buckets and the production
# batch B = 128
KERNEL_CASES = {
    (3, 40, 25): (8, 8, 1, 16),
    (8, 5, 25): (8, 1, 1, 128),
    (16, 64, 900): (8, 8, 1, 16),
    (128, 64, 900): (8, 8, 1, 16),
    (2, 256, 900): (8, 32, 1, 4),
    (2, 257, 900): (8, 32, 2, 1),
    (128, 480, 300): (8, 32, 2, 1),
    (128, 481, 300): (8, 32, 3, 1),
    (64, 700, 900): (8, 32, 3, 1),
    (16, 1920, 900): (8, 32, 8, 1),
    (128, 1920, 900): (8, 32, 8, 1),
    (1, 4096, 900): (8, 32, 18, 1),
    (128, 4096, 100): (8, 32, 18, 1),
}


@pytest.mark.parametrize("B,T,n_cycles", list(KERNEL_CASES))
def test_launch_plan_layouts(B, T, n_cycles):
    """The plan of each kernel case below (a host-side choice, checked
    without a card), and the limits the CUDA entry point enforces: the
    least layout that holds T, at most 576 threads a block."""
    K, L, W, R = plan = fs.launch_plan(B, T)
    assert plan == KERNEL_CASES[(B, T, n_cycles)]
    assert L & (L - 1) == 0 and 1 <= L <= 32 and (W == 1 or (L == 32 and R == 1))
    if W == 1:
        assert L * K >= T > L * K // 2 or L == 1
    else:
        assert 30 * K * W >= T > 30 * K * (W - 1) and T > 32 * K
    assert (R * L * W) % 32 == 0 and R * L * W <= 576


@pytest.mark.parametrize("T", [0, 4097])
def test_launch_plan_refuses_t_out_of_range(T):
    with pytest.raises(ValueError, match="outside"):
        fs.launch_plan(4, T)


# The card's cases: every planned case above, the shapes earlier kernels
# were held at (one lane a row at 900 cycles, where a race shows that 25
# cycles hide; odd B; the path's B = 32 bucket), and rows of L = 2 and
# L = 4 lanes at 900 cycles
CARD_CASES = sorted(set(KERNEL_CASES) | {
    (5, 16, 4), (2, 64, 900), (7, 5, 900), (33, 700, 900), (32, 1920, 900),
    (8, 16, 900), (8, 32, 900),
})


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,n_cycles", CARD_CASES)
def test_filter_sgd_kernel_matches_plain(cuda, B, T, n_cycles):
    """Live rows within 2e-4 of the plain version; their masked tails, and
    the all-masked padding rows (whole warps of them when 32 / L rows share
    a warp), equal to x0 exactly."""
    live = B - B // 4
    ins = _inputs(B, T, cuda, live=live)
    before = fs.filter_sgd.launches
    got = fs.filter_sgd(*ins, 20.0, n_cycles)
    torch.cuda.synchronize()
    assert fs.filter_sgd.launches == before + 1
    want = fs.filter_sgd_plain(*ins, 20.0, n_cycles)
    masked = (ins[6][:live] == 0)[:, :, None].expand(-1, -1, 50)
    for g, w, x0 in zip(got, want, ins[:3]):
        torch.testing.assert_close(g[:live], w[:live], atol=2e-4, rtol=0)
        assert torch.equal(g[:live][masked], x0[:live][masked])
        assert torch.equal(g[live:], x0[live:])


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


@pytest.mark.parametrize("N,D,offset,path", [
    (4, 8, 0, "float4"), (4, 10, 0, "scalar"), (4, 8, 1, "scalar"),
    (4, 8, 4, "float4"),
])
def test_robust_launch_path(N, D, offset, path):
    """float4 only for D % 4 == 0 on a 16-byte boundary (a host-side choice,
    checked without a card); a storage offset of one float breaks it."""
    flat = torch.zeros(N * D + offset)
    assert rl.launch_path(flat[offset:].view(N, D)) == path


def _misaligned(x):
    """A contiguous copy of x that starts one float past a 16-byte boundary."""
    flat = torch.empty(x.numel() + 1, device=x.device)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("N,D,layout", [
    (128, 48384, "contiguous"), (64, 48384, "contiguous"), (7, 1000, "contiguous"),
    (1, 1, "contiguous"), (300, 257, "contiguous"), (7, 1000, "offset"),
    (7, 1000, "strided"),
])
def test_robust_loss_kernel_matches_plain(cuda, N, D, layout):
    """The float4 pass (D % 4 == 0, aligned) and the scalar one (D % 4 != 0,
    or a contiguous view one float off a 16-byte boundary); a strided view
    is copied by the wrapper and so takes the float4 pass."""
    x, alpha, c = _robust_inputs(N, D, cuda)
    if layout == "offset":
        x = _misaligned(x)
        assert rl.launch_path(x) == "scalar"
    elif layout == "strided":
        x = torch.cat([x, x], dim=1)[:, ::2]
        assert not x.is_contiguous() and rl.launch_path(x.contiguous()) == "float4"
    else:
        assert rl.launch_path(x) == ("float4" if D % 4 == 0 else "scalar")
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
