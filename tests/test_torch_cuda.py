"""The port's CUDA kernels on the card (marked ``cuda``; skipped without
one), and the host-side launch plans, which run anywhere, with the long-row
filter's segmented schedule replayed on the CPU in the plain arithmetic.

This file imports torch and the port only, so it runs on a machine without
JAX.  There, skip the JAX-only conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances, each against the kernel's plain PyTorch version and each the
JAX package's own for its Pallas kernel: the filter atol 2e-4
(test_pallas_kernels.py:44); the robust loss rtol 1e-5 / atol 1e-6, its dx
rtol 1e-4 / atol 1e-6 (test_pallas_kernels.py:108, :122).  The classifier
LSTM (cuDNN, no kernel of the port) is held against a float64 evaluation
on the CPU: the card's float32 logits may be twice as far from it as the
CPU's float32 ones, and TF32 must miss that bound.  The featurizer towers
(cuBLAS and cuDNN, no kernel of the port) at mid widths against the CPU on
the same seeded weights: within 2^-15 of the output's largest value, the
generators' raw-output rule, or for ResNet-50 where cuDNN breaks it, within
twice the CPU's float32 error against float64.  The lifting alternatives:
``filter_xyz`` and the single-clip v2 API launch the filter kernel; the
closed form ``filter_xyz_matpow`` at 'float32' within 3e-4 of the kernel
(the JAX package's matpow bound, test_pallas_kernels.py:62-82).
"""

import numpy as np
import pytest
import torch

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.infer import (
    conv_matmul_precision,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.lifting import (
    engine,
    filtering,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models import (
    clip_vision,
    resnet,
    text_encoders,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models.classifier import (
    build_classifier,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops import (
    filter_sgd as fs,
    robust_loss as rl,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _long_inputs(B, T, device="cpu", seed=0):
    """Random planes for long rows, each with another live end: row 0 a
    masked tail of 101 steps, row 1 half masked, row 2 all live, row 3 all
    masked (the pow2 padding of a batch)."""
    ins = _inputs(B, T, device, seed=seed, live=B)
    ends = [T - 101, T // 2, T, 0]
    mask = ins[6]
    for b in range(B):
        mask[b] = 0.0
        mask[b, : ends[b % 4]] = 1.0
    ins[5] *= mask[:, :, None]
    return ins


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


# (B, T) -> the plan of a row longer than one block's 4320 steps (K, L, W,
# R, G, H): G segments of W - 2 owned warps, H = 240 steps of halo and
# cycles a launch; T = 4097 (the first T the kernel once refused) and 4320
# stay in one block of 18 warps
LONG_CASES = {
    (1, 4097): (8, 32, 18, 1),
    (4, 4320): (8, 32, 18, 1),
    (1, 4321): (8, 32, 12, 1, 2, 240),
    (4, 4321): (8, 32, 12, 1, 2, 240),
    (1, 8641): (8, 32, 15, 1, 3, 240),
    (4, 8641): (8, 32, 15, 1, 3, 240),
    (1, 20000): (8, 32, 16, 1, 6, 240),
    (4, 20000): (8, 32, 16, 1, 6, 240),
    (2, 5000): (8, 32, 13, 1, 2, 240),
    (1, 69121): (8, 32, 18, 1, 19, 240),
}


@pytest.mark.parametrize("B,T", list(LONG_CASES))
def test_launch_plan_long_rows(B, T):
    """Segments of at most 16 owned warps cover the row, and no fewer would
    do; each block (owned warps and the two halo warps) stays within 576
    threads."""
    plan = fs.launch_plan(B, T)
    assert plan == LONG_CASES[(B, T)]
    if len(plan) == 4:
        K, L, W, R = plan
        assert 30 * K * W >= T > 30 * K * (W - 1) and W <= 18
        return
    K, L, W, R, G, H = plan
    assert (K, L, R, H) == (8, 32, 1, 30 * K) and T > 18 * H
    assert (W - 2) * H * G >= T > (W - 3) * H * G and W - 2 <= 16
    assert 16 * H * (G - 1) < T and 32 * W <= 576


@pytest.mark.parametrize("T", [0])
def test_launch_plan_refuses_t_out_of_range(T):
    with pytest.raises(ValueError, match="outside"):
        fs.launch_plan(4, T)


def _windowed_plain(ins, lr, n_cycles):
    """The segmented schedule of a long row, run with the plain version's
    arithmetic: each segment's block holds its owned steps, H steps of
    halo on either side and the halo lanes' 8 more, knows nothing beyond
    them (NaN there), takes the whole row's t_real, and runs at most H
    cycles a launch from the state the last launch wrote."""
    import torch.nn.functional as F

    x0, y0, z0, tarx, tary, w, mask = ins
    B, T = mask.shape
    K, L, W, R, G, H = fs.launch_plan(B, T)
    S, P = (W - 2) * H, H + K  # owned steps; a window's reach past them
    t_real = mask.sum(dim=1)[:, None, None]
    denom_data, denom_smooth = t_real * 50, (t_real - 1.0) * 50
    extra = P + G * S - T

    def pad(a):
        return F.pad(a, (0, 0, P, extra)) if a.dim() == 3 else F.pad(a, (P, extra))

    m, tx, ty, wm = pad(mask), pad(tarx), pad(tary), pad(w * mask[:, :, None])
    state = [x0, y0, z0]
    nan = float("nan")
    for i in range(-(-n_cycles // H)):
        cycles = min(H, n_cycles - i * H)
        full = [pad(s) for s in state]
        new = [torch.empty_like(s) for s in state]
        for g in range(G):
            lo, hi = g * S, g * S + S + 2 * P  # the window in padded steps
            mw = m[:, lo:hi]
            pair = (mw[:, :-1] * mw[:, 1:])[:, :, None]
            xs, ys, zs = (s[:, lo:hi] for s in full)
            txw, tyw, wmw = tx[:, lo:hi], ty[:, lo:hi], wm[:, lo:hi]

            def smooth(s):
                d2 = 2.0 * ((s[:, :-1] - s[:, 1:]) * pair)
                return (F.pad(d2, (0, 0, 0, 1), value=nan)
                        - F.pad(d2, (0, 0, 1, 0), value=nan))

            for _ in range(cycles):
                gx = 2.0 * wmw * (xs - txw) / denom_data + smooth(xs) / denom_smooth
                gy = 2.0 * wmw * (ys - tyw) / denom_data + smooth(ys) / denom_smooth
                gz = smooth(zs) / denom_smooth
                xs, ys, zs = xs - lr * gx, ys - lr * gy, zs - lr * gz
            own = slice(g * S, min(T, g * S + S))
            for n, s in zip(new, (xs, ys, zs)):
                n[:, own] = s[:, P : P + own.stop - own.start]
        state = new
    return state


@pytest.mark.parametrize("B,T,n_cycles", [(2, 4321, 500), (1, 8641, 250),
                                          (1, 20000, 241)])
def test_segmented_schedule_is_exact(B, T, n_cycles):
    """The long-row plan's windows, halos and relaunches reproduce the
    whole row's plain filter bit for bit (NaN past a window would show
    wherever a halo is too short), masked tails and a last launch of fewer
    than H cycles included.  This is the schedule the CUDA kernel runs; the
    kernel's own arithmetic is held on the card below."""
    ins = _long_inputs(B, T)
    got = _windowed_plain(ins, 20.0, n_cycles)
    want = fs.filter_sgd_plain(*ins, 20.0, n_cycles)
    live = ins[6].sum(dim=1) > 0
    for g, w in zip(got, want):
        assert torch.equal(g[live], w[live])


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
    with pytest.raises(ValueError):  # a mask one step short of the planes
        fs.filter_sgd(*ins[:6], ins[6][:, :7].contiguous(), 20.0, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("B,live", [(4, 3), (1, 1)])
def test_filter_sgd_replay_raw_smoke_batch_matches_plain(cuda, B, live):
    """The article replay's raw smoke: 24-frame clips in the T = 64 bucket
    (a batch of three padded to four, and one alone) at 60 cycles; live
    steps within 2e-4 of the plain version, the masked tail of each row and
    the padding row equal to x0 exactly."""
    ins = _inputs(B, 64, cuda, live=live)
    ins[6][:, 24:] = 0.0
    ins[5] *= ins[6][:, :, None]
    before = fs.filter_sgd.launches
    got = fs.filter_sgd(*ins, 20.0, 60)
    torch.cuda.synchronize()
    assert fs.filter_sgd.launches == before + 1
    want = fs.filter_sgd_plain(*ins, 20.0, 60)
    masked = (ins[6][:live] == 0)[:, :, None].expand(-1, -1, 50)
    for g, w, x0 in zip(got, want, ins[:3]):
        torch.testing.assert_close(g[:live], w[:live], atol=2e-4, rtol=0)
        assert torch.equal(g[:live][masked], x0[:live][masked])
        assert torch.equal(g[live:], x0[live:])


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", [k for k in LONG_CASES if k[1] <= 20000])
def test_filter_sgd_long_rows_match_plain(cuda, B, T):
    """Rows longer than one block (and T = 4097, 4320 in one block) at 900
    cycles: live rows within 2e-4 of the plain version, masked tails and
    all-masked rows equal to x0 exactly, ceil(900 / 240) launches for a
    segmented row."""
    ins = _long_inputs(B, T, cuda)
    plan = fs.launch_plan(B, T)
    before = fs.filter_sgd.launches
    got = fs.filter_sgd(*ins, 20.0, 900)
    torch.cuda.synchronize()
    assert fs.filter_sgd.launches == before + (4 if len(plan) == 6 else 1)
    want = fs.filter_sgd_plain(*ins, 20.0, 900)
    live = ins[6].sum(dim=1) > 0
    masked = (ins[6] == 0)[:, :, None].expand(-1, -1, 50)
    for g, w, x0 in zip(got, want, ins[:3]):
        torch.testing.assert_close(g[live], w[live], atol=2e-4, rtol=0)
        assert torch.equal(g[masked], x0[masked])


@pytest.mark.cuda
def test_filter_sgd_long_row_keeps_the_arithmetic(cuda):
    """One clip of 4000 steps, alone (one block of 17 warps) and padded to
    5000 with its mask past 4000 (two segments, four launches): the live
    output is the same to the bit, since every step runs the same
    instructions in the same lane and slot."""
    short = _long_inputs(1, 4000, cuda)
    short[6].fill_(1.0)
    padded = [torch.cat([a, torch.randn_like(a)[:, :1000]], dim=1) for a in short]
    padded[6][:, 4000:] = 0.0
    padded[5][:, 4000:] = 0.0
    assert len(fs.launch_plan(1, 5000)) == 6 and len(fs.launch_plan(1, 4000)) == 4
    a = fs.filter_sgd(*short, 20.0, 900)
    b = fs.filter_sgd(*padded, 20.0, 900)
    torch.cuda.synchronize()
    for u, v, x0 in zip(a, b, padded[:3]):
        assert torch.equal(u, v[:, :4000])
        assert torch.equal(v[:, 4000:], x0[:, 4000:])


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
    # the article replay's v2+text residual at its batch of 256, the last
    # partial batch of an article-scale epoch (31128 % 256), and K = 3
    (256, 4608, "contiguous"), (152, 4608, "contiguous"), (256, 13824, "contiguous"),
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


@pytest.mark.cuda
def test_classifier_lstm_on_the_card_is_float32(cuda):
    """A mid-width bidirectional LSTM (hidden 256, 2 layers, T=192), seeded
    weights: the card's logits within 2x the CPU's float32 error against a
    float64 evaluation; with TF32 on, beyond it."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(16, 192, 288).astype(np.float32))
    kw = dict(input_size=288, hidden_size=256, num_layers=2, bidirectional=True)
    cpu = build_classifier("lstm", device="cpu", **kw)
    card = build_classifier("lstm", device=cuda, **kw)
    with torch.no_grad():
        want = cpu(x).double()
        ref = cpu.double()(x.double())
        got = {}
        for precision in ("float32", "tensorfloat32"):
            with conv_matmul_precision(precision):
                got[precision] = card(x.to(cuda)).double().cpu()
    err_cpu = float((want - ref).abs().max())
    assert 0 < float((got["float32"] - ref).abs().max()) <= 2 * err_cpu
    assert float((got["tensorfloat32"] - ref).abs().max()) > 2 * err_cpu


def _tower_case(name, g):
    """(constructor, inputs) of a tower at mid width, inputs from ``g``."""
    if name == "bert":
        ids = torch.randint(0, 1000, (4, 128), generator=g)
        mask = torch.ones_like(ids)
        mask[1, 70:] = 0
        return lambda: text_encoders.BertEncoder(1000, 256, 4, 4, 1024, 512), (ids, mask)
    if name == "clip_text":
        ids = torch.randint(0, 999, (4, 77), generator=g)
        ids[:, 30] = 999
        return (lambda: text_encoders.CLIPTextEncoder(1000, 256, 4, 4, 1024, 77, 128,
                                                      eos_token_id=999), (ids,))
    if name == "clip_vision":
        return (lambda: clip_vision.CLIPVisionEncoder(256, 4, 4, 1024, 224, 32, 128),
                (torch.randn(4, 3, 224, 224, generator=g),))
    return resnet.ResNet50, (torch.randn(8, 3, 120, 120, generator=g),)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bert", "clip_text", "clip_vision", "resnet50"])
def test_featurizer_tower_on_the_card_is_float32(cuda, name):
    g = torch.Generator().manual_seed(0)
    make, inputs = _tower_case(name, g)
    if name == "resnet50":
        cpu = resnet.load_resnet50(None, device="cpu", generator=g)
    else:
        cpu = text_encoders.materialize(make, "cpu", generator=g)
    card = text_encoders.materialize(make, cuda, state_dict=cpu.state_dict())
    with torch.no_grad(), conv_matmul_precision("float32"):
        want = cpu(*inputs)
        got = card(*(x.to(cuda) for x in inputs)).cpu()
    err = float((got - want).abs().max())
    if err <= 2.0**-15 * float(want.abs().max()):
        return
    assert name == "resnet50", (name, err, float(want.abs().max()))
    with torch.no_grad():
        ref = cpu.double()(inputs[0].double())
    assert float((got - ref).abs().max()) <= 2 * float((want - ref).abs().max())


@pytest.mark.cuda
def test_filter_xyz_launches_the_kernel(cuda):
    """The public ``filtering.filter_xyz`` on CUDA tensors is the kernel:
    one more launch, the plain version's result within 2e-4."""
    ins = _inputs(4, 100, cuda, live=3)
    before = fs.filter_sgd.launches
    got = filtering.filter_xyz(*ins[:6], 20.0, 300, mask=ins[6])
    torch.cuda.synchronize()
    assert fs.filter_sgd.launches == before + 1
    want = fs.filter_sgd_plain(*ins, 20.0, 300)
    for g, w in zip(got, want):
        torch.testing.assert_close(g[:3], w[:3], atol=2e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", [(8, 64), (4, 256)])
def test_filter_matpow_float32_matches_the_kernel(cuda, B, T):
    """The closed form at 'float32' (TF32 off) within 3e-4 of the kernel on
    the card at 900 cycles; at 'tensorfloat32' it is reported, not held."""
    ins = _inputs(B, T, cuda, live=B)
    want = fs.filter_sgd(*ins, 20.0, 900)
    got = filtering.filter_xyz_matpow(*ins, 20.0, 900, precision="float32")
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=3e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [64, 1920, 5000])
def test_v2_single_clip_runs_the_kernel(cuda, T):
    """The single-clip v2 API is a batch of one through the kernel (one
    block a row, or segments past 4,320 steps): launches counted, within
    2e-4 of the plain loop on the same snapshot."""
    rng = np.random.RandomState(T)
    lines = rng.uniform(-3, -1, 25).astype(np.float32)
    roots = [rng.randn(T, 1).astype(np.float32) for _ in range(3)]
    angles = [rng.randn(T, 49).astype(np.float32) for _ in range(3)]
    tar = [rng.randn(T, 50).astype(np.float32) for _ in range(2)]
    w = rng.rand(T, 50).astype(np.float32)
    before = fs.filter_sgd.launches
    got = filtering.backpropagation_based_filtering_v2(lines, *roots, *angles, *tar, w,
                                                       nCycles=900, device=cuda)
    torch.cuda.synchronize()
    plan = fs.launch_plan(1, T)
    # a segmented row relaunches every H cycles
    assert fs.filter_sgd.launches - before == (-(-900 // plan[5]) if len(plan) == 6 else 1)
    x0, y0, z0 = filtering.fk_from_angles(*(torch.from_numpy(a)[None].to(cuda)
                                            for a in (lines, *roots, *angles)))
    want = fs.filter_sgd_plain(x0, y0, z0, *(torch.from_numpy(a)[None].to(cuda)
                                             for a in (*tar, w)),
                               torch.ones(1, T, device=cuda), 20.0, 900)
    for g, w_ in zip(got, want):
        assert g.shape == (T, 50)
        torch.testing.assert_close(g, w_[0], atol=2e-4, rtol=0)


@pytest.mark.cuda
def test_lifting_entry_points_run_the_kernel_whatever_the_environment(cuda, monkeypatch):
    """The JAX package's switches (MHPE_LIFT_FILTER=xla, MHPE_LIFT_PALLAS=0)
    select nothing in the port: ``lift_clip`` and ``lift_clips`` without a
    ``filter_impl`` launch the kernel on the card, one launch a batch."""
    monkeypatch.setenv("MHPE_LIFT_FILTER", "xla")
    monkeypatch.setenv("MHPE_LIFT_PALLAS", "0")
    rng = np.random.RandomState(3)
    clips = [rng.rand(T, 150).astype(np.float32) for T in (40, 100)]
    before = fs.filter_sgd.launches
    engine.lift_clip(clips[0], n_cycles=20, device=cuda)
    engine.lift_clips(clips, n_cycles=20, device=cuda)
    assert fs.filter_sgd.launches - before == 3

