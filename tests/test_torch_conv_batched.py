"""The whole-batch convolution form of the GAN steps (``ops/conv``).

* The form against ``F.conv1d`` / ``F.conv_transpose1d`` in float64, in the
  output and the input, weight and bias gradients, at every (C_in, C_out,
  k, stride, padding, output_padding) that the v1, v2, v4, v4_deeper and
  b2h generators and the discriminator use, at odd and even lengths; a
  test holds that list to the models' modules.
* Whole G, D and val steps of v1 and v2 (and the fused D step) with the
  form forced on the CPU, by patching the predicate, against the stock
  step, both in float64: the loss, every gradient and every running
  statistic.
* At bfloat16, every layer's output and weight gradient within one
  bfloat16 rounding of the float64 convolution of the same bfloat16
  operands (float32 accumulation, the bias inside the product), and whole
  forced bfloat16 steps against the stock bfloat16 step.
* The forward's parts of K: equal, at most ``CHUNK`` long, as few as
  that allows, for every layer.
* The predicate: a CUDA tensor with cuDNN off only, so inference (cuDNN
  on) and the CPU keep ``F.conv1d``; the tracer's ``train.conv_batched``
  counts every convolution of a forced step and none of inference.

The form's arithmetic is the stock convolution's in another order of the
same float64 sums, so every comparison is at 1e-12 of the largest value.
"""

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.infer import run_inference
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models import registry
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops import conv
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.train import gan
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils import profiling

REL = 1e-12

# ("c" Conv1d | "t" ConvTranspose1d, C_in, C_out, k, stride, padding, output_padding)
LAYERS = [
    ("c", 36, 256, 3, 1, 1, 0), ("c", 36, 512, 3, 1, 1, 0), ("c", 264, 512, 3, 1, 1, 0),
    ("c", 256, 256, 3, 1, 1, 0), ("c", 512, 512, 3, 1, 1, 0), ("c", 512, 256, 3, 1, 1, 0),
    ("c", 256, 256, 5, 2, 2, 0), ("c", 512, 512, 5, 2, 2, 0), ("c", 512, 256, 5, 2, 2, 0),
    ("c", 252, 252, 7, 1, 3, 0), ("c", 24, 24, 7, 1, 3, 0),
    ("t", 256, 252, 7, 2, 3, 1), ("t", 512, 252, 7, 2, 3, 1), ("t", 512, 24, 7, 2, 3, 1),
    ("c", 252, 64, 5, 2, 2, 0), ("c", 24, 64, 5, 2, 2, 0), ("c", 64, 64, 5, 2, 2, 0),
    ("c", 64, 32, 5, 2, 2, 0), ("c", 32, 32, 5, 2, 2, 0), ("c", 32, 16, 5, 2, 2, 0),
    ("c", 16, 16, 5, 2, 2, 0), ("c", 16, 8, 5, 2, 2, 0), ("c", 8, 1, 3, 1, 1, 0),
]

# the generators at their published widths, as the configurations build them
MODELS = [("v1", 36, 252, {}), ("v1", 36, 252, {"require_text": True}),
          ("v2", 264, 24, {"require_text": True}), ("v2", 36, 252, {}),
          ("v4", 36, 252, {"require_text": True}), ("v4", 36, 252, {}),
          ("v4_deeper", 36, 252, {"require_text": True}), ("v4_deeper", 36, 252, {}),
          ("b2h", 36, 252, {"require_image": True}), ("b2h", 36, 252, {})]


def _signature(m):
    if isinstance(m, nn.ConvTranspose1d):
        return ("t", m.in_channels, m.out_channels, m.kernel_size[0], m.stride[0],
                m.padding[0], m.output_padding[0])
    if isinstance(m, nn.Conv1d):
        return ("c", m.in_channels, m.out_channels, m.kernel_size[0], m.stride[0],
                m.padding[0], 0)
    return None


def test_the_cases_are_every_convolution_of_the_models():
    seen = set()
    nets = [registry.build_generator(name, din, dout, device="cpu", **kw)
            for name, din, dout, kw in MODELS]
    nets += [registry.build_discriminator(dout, device="cpu") for dout in (252, 24)]
    for net in nets:
        seen |= {_signature(m) for m in net.modules()} - {None}
    assert seen == set(LAYERS)


def _close(got, want):
    got, want = got.detach(), want.detach()
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= REL * max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("T", [12, 13], ids=["even", "odd"])
@pytest.mark.parametrize("layer", LAYERS, ids=["-".join(map(str, c)) for c in LAYERS])
def test_form_matches_the_stock_convolution_in_float64(layer, T):
    kind, cin, cout, k, s, p, op = layer
    g = torch.Generator().manual_seed(cin * 1000 + cout + T)
    x = torch.randn(2, cin, T, generator=g, dtype=torch.float64, requires_grad=True)
    shape = (cout, cin, k) if kind == "c" else (cin, cout, k)
    w = torch.randn(shape, generator=g, dtype=torch.float64, requires_grad=True)
    b = torch.randn(cout, generator=g, dtype=torch.float64, requires_grad=True)
    if kind == "c":
        want, got = F.conv1d(x, w, b, s, p), conv.conv1d_gemm(x, w, b, s, p)
    else:
        want = F.conv_transpose1d(x, w, b, s, p, op)
        got = conv.conv_transpose1d_gemm(x, w, b, s, p, op)
    _close(got, want)
    gy = torch.randn(want.shape, generator=g, dtype=torch.float64)
    for a, c in zip(torch.autograd.grad(got, (x, w, b), gy),
                    torch.autograd.grad(want, (x, w, b), gy)):
        _close(a, c)


@pytest.mark.parametrize("layer", LAYERS, ids=["-".join(map(str, c)) for c in LAYERS])
def test_the_forward_sums_k_in_equal_parts_of_at_most_chunk(layer):
    """K = C*k of a Conv1d and every phase's taps*C of a transposed one."""
    kind, cin, _, k, s, _, _ = layer
    for K in ([cin * k] if kind == "c" else [cin * len(range(j, k, s)) for j in range(s)]):
        parts = conv._chunks(K)
        assert K % parts == 0 and K // parts <= conv.CHUNK
        assert parts == 1 or K // (parts - 1) > conv.CHUNK or K % (parts - 1)


BF16_U = 2.0**-8  # a bfloat16 rounding, relative


def _conv(kind, x, w, b, s, p, op, gemm):
    if kind == "c":
        return (conv.conv1d_gemm if gemm else F.conv1d)(x, w, b, s, p)
    return (conv.conv_transpose1d_gemm if gemm else F.conv_transpose1d)(x, w, b, s, p, op)


@pytest.mark.parametrize("layer", LAYERS, ids=["-".join(map(str, c)) for c in LAYERS])
def test_form_at_bfloat16_rounds_each_product_once(layer):
    """bfloat16 operands, float32 accumulation, one rounding of each result:
    against the float64 convolution of the same bfloat16 values, with
    ``R`` the same convolution of their absolute values (the bound on the
    accumulation, 2^-14 R here, far above the CPU's float32 sums; the
    card's bfloat16 tensor cores take more, tests/test_torch_cuda.py),
    the output and the weight gradient within u |ref| + 2^-14 R.  The bias
    gradient's phases of a transposed convolution are summed in bfloat16
    (one more rounding, u R), and the input gradient is the columns'
    rounded gradient overlap-added in bfloat16 (at most k more, k u R)."""
    kind, cin, cout, k, s, p, op = layer
    g = torch.Generator().manual_seed(cin * 1000 + cout)
    x = torch.randn(2, cin, 13, generator=g).bfloat16()
    w = torch.randn((cout, cin, k) if kind == "c" else (cin, cout, k), generator=g).bfloat16()
    b = torch.randn(cout, generator=g).bfloat16()
    leaves = [a.clone().requires_grad_() for a in (x, w, b)]
    y = _conv(kind, *leaves, s, p, op, True)
    gy = torch.randn(y.shape, generator=g).bfloat16()
    got = [y] + list(torch.autograd.grad(y, leaves, gy))
    exact = [a.double().requires_grad_() for a in (x, w, b)]
    y64 = _conv(kind, *exact, s, p, op, False)
    want = [y64] + list(torch.autograd.grad(y64, exact, gy.double()))
    absolute = [a.double().abs().requires_grad_() for a in (x, w, b)]
    ya = _conv(kind, *absolute, s, p, op, False)
    bound = [ya] + list(torch.autograd.grad(ya, absolute, gy.double().abs()))
    extra = [2.0**-14, k * BF16_U, 2.0**-14, BF16_U if kind == "t" else 2.0**-14]
    for what, a, c, r, e in zip(("y", "x", "w", "b"), got, want, bound, extra):
        assert a.dtype == torch.bfloat16, what
        err = (a.detach().double() - c.detach()).abs()
        assert bool((err <= BF16_U * c.detach().abs() + e * r.detach()).all()), what


def test_form_without_bias():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 4, 9, generator=g, dtype=torch.float64)
    w = torch.randn(6, 4, 3, generator=g, dtype=torch.float64)
    _close(conv.conv1d_gemm(x, w, None, 2, 1), F.conv1d(x, w, None, 2, 1))
    wt = torch.randn(4, 6, 7, generator=g, dtype=torch.float64)
    _close(conv.conv_transpose1d_gemm(x, wt, None, 2, 3, 1),
           F.conv_transpose1d(x, wt, None, 2, 3, 1))


def test_the_predicate_is_a_cuda_tensor_with_cudnn_off(monkeypatch):
    card = types.SimpleNamespace(is_cuda=True)
    for enabled in (True, False):
        monkeypatch.setattr(torch.backends.cudnn, "enabled", enabled)
        assert conv.batched(card) is not enabled
        assert not conv.batched(torch.zeros(1))


# ----------------------------------------------------------------------
# whole steps, the form forced on the CPU
# ----------------------------------------------------------------------
B, T, SIZE = 4, 32, 32
STEP_MODELS = {"v1": dict(model="v1", feature_in_dim=36, feature_out_dim=252, loss="L1"),
               "v2": dict(model="v2", feature_in_dim=264, feature_out_dim=24,
                          loss="RobustLoss", require_text=True)}


def _trainer(name, **over):
    cfg = gan.GanConfig(default_size=SIZE, window_t=T, batch_size=B, **STEP_MODELS[name],
                        **over)
    tr = gan.GanTrainer(cfg, device="cpu")
    for m in (tr.generator, tr.discriminator, tr.adaptive):
        if m is not None:
            m.double()
    return tr


def _batch(name):
    rng = np.random.RandomState(3)
    cfg = STEP_MODELS[name]
    x = torch.from_numpy(rng.randn(B, T, cfg["feature_in_dim"]))
    y = torch.from_numpy(rng.randn(B, T, cfg["feature_out_dim"]))
    return x, y, torch.from_numpy(rng.randn(B, 512)) if cfg.get("require_text") else None


def _forced(monkeypatch):
    monkeypatch.setattr(conv, "batched", lambda x: True)


@pytest.mark.parametrize("kind", ["g", "d", "val", "fused_d"])
@pytest.mark.parametrize("name", ["v1", "v2"])
def test_forced_step_matches_the_stock_step_in_float64(monkeypatch, name, kind):
    over = {"fused_d": True} if kind == "fused_d" else {}
    step = "d" if kind == "fused_d" else kind
    stock, forced = _trainer(name, **over), _trainer(name, **over)
    args = _batch(name)
    want = stock._step(step)(*args)
    _forced(monkeypatch)
    profiling.enable()
    try:
        got = forced._step(step)(*args)
    finally:
        profiling.disable()
    assert profiling.snapshot()["counts"]["train.conv_batched"] > 0
    assert got.dtype == torch.float64
    assert abs(float(got) - float(want)) <= REL * max(1.0, abs(float(want)))
    # the gradients (Adam's first step divides each by its own size, so the
    # step itself is held through them) and the running statistics
    for a, b in ((stock.generator, forced.generator),
                 (stock.discriminator, forced.discriminator)):
        for (k, p), q in zip(a.named_parameters(), b.parameters()):
            assert (p.grad is None) == (q.grad is None), k
            if p.grad is not None:
                _close(q.grad, p.grad)
        for (k, u), v in zip(a.named_buffers(), b.buffers()):
            _close(v.double(), u.double())


@pytest.mark.parametrize("kind", ["g", "d", "val", "fused_d"])
@pytest.mark.parametrize("name", ["v1", "v2"])
def test_forced_bfloat16_step_matches_the_stock_bfloat16_step(monkeypatch, name, kind):
    """``compute_dtype="bfloat16"``: the form's bfloat16 products (one GEMM,
    the bias inside it) in a whole step against the stock step's PyTorch
    convolutions at bfloat16 (float32 models and batch, as the trainer
    runs).  The two round in other places, and this batch of 4 is
    ill-conditioned at bfloat16, so they are held at four bfloat16
    roundings (2^-6): the loss relative, the running statistics against
    the largest; every gradient of the float32 masters float32 and
    finite where the stock step's is."""
    over = {"compute_dtype": "bfloat16", "fused_d": kind == "fused_d"}
    step = "d" if kind == "fused_d" else kind
    stock, forced = _trainer(name, **over), _trainer(name, **over)
    for tr in (stock, forced):
        for m in (tr.generator, tr.discriminator, tr.adaptive):
            if m is not None:
                m.float()
    args = [None if a is None else a.float() for a in _batch(name)]
    want = float(stock._step(step)(*args))
    _forced(monkeypatch)
    profiling.enable()
    try:
        got = float(forced._step(step)(*args))
    finally:
        profiling.disable()
    assert profiling.snapshot()["counts"]["train.conv_batched"] > 0
    assert abs(got - want) <= 2.0**-6 * abs(want)
    for a, b in ((stock.generator, forced.generator),
                 (stock.discriminator, forced.discriminator)):
        for (k, p), q in zip(a.named_parameters(), b.parameters()):
            assert (p.grad is None) == (q.grad is None), k
            if q.grad is not None:
                assert q.grad.dtype == torch.float32 and bool(q.grad.isfinite().all()), k
        for (k, u), v in zip(a.named_buffers(), b.buffers()):
            if u.is_floating_point():
                assert float((v - u).abs().max()) <= 2.0**-6 * max(1.0, float(u.abs().max())), k


def _convs(module):
    return sum(_signature(m) is not None for m in module.modules())


@pytest.mark.parametrize("kind", ["g", "d", "val", "fused_d"])
def test_conv_batched_counts_every_convolution_of_a_step(monkeypatch, kind):
    """G step: G's forward and D's scoring of the fake; D step: G's
    forward and D's two passes (one with ``fused_d``); val: G's forward."""
    tr = _trainer("v2", fused_d=kind == "fused_d")
    n_g, n_d = _convs(tr.generator), _convs(tr.discriminator)
    assert (n_g, n_d) == (9, 8)
    want = {"g": n_g + n_d, "d": n_g + 2 * n_d, "val": n_g, "fused_d": n_g + n_d}[kind]
    _forced(monkeypatch)
    profiling.enable()
    try:
        for _ in range(2):
            tr._step("d" if kind == "fused_d" else kind)(*_batch("v2"))
    finally:
        profiling.disable()
    snap = profiling.snapshot()
    step = "train.d_step" if kind == "fused_d" else f"train.{kind}_step"
    assert snap["spans"][step]["n"] == 2
    assert snap["counts"]["train.conv_batched"] == 2 * want


def test_inference_and_the_cpu_keep_the_stock_convolution(monkeypatch):
    """Unforced, a CPU step and ``run_inference`` never reach the form:
    the counter stays at zero and the GEMM form is never called."""
    def refuse(*a, **k):
        raise AssertionError("the whole-batch form ran")

    monkeypatch.setattr(conv, "conv1d_gemm", refuse)
    monkeypatch.setattr(conv, "conv_transpose1d_gemm", refuse)
    tr = _trainer("v1")
    x, y, _ = _batch("v1")
    profiling.enable()
    try:
        tr.g_step(x, y)
        tr.generator.float()
        run_inference(tr.generator, x.float().numpy(), batch_size=2, device="cpu")
    finally:
        profiling.disable()
    assert "train.conv_batched" not in profiling.snapshot()["counts"]
