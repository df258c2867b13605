"""The generators' and the discriminator's 1D convolutions, whole-batch.

With cuDNN off, PyTorch's own CUDA convolution (``aten::_slow_conv2d_*``)
runs im2col and a GEMM one sample at a time, and col2im per sample in the
backward: ~12.5K launches a GAN step at B=128.  The GAN steps turn cuDNN
off for precision (``train/gan._float32``), so there, and wherever else a
CUDA tensor meets a convolution with cuDNN off (``batched``), the
convolution is written here as whole-batch products instead:

  * ``conv1d``: the padded input's strided view (``Tensor.unfold``), copied
    once into a (C*k, B*T_out) column matrix, and the product
    ``W (O, C*k) @ cols`` with the bias (``_Product``: its forward one
    batched GEMM over parts of C*k and their sum, its backward one GEMM
    for each gradient).  The weight gradient is one GEMM reducing over
    B*T_out, the input gradient one GEMM and one batch-wide overlap-add
    (unfold's own backward), the bias gradient one sum.
  * ``conv_transpose1d``: polyphase.  Output phase r of the s phases is a
    plain correlation of the input with the taps j = r + p - s*q, so the
    phases share one tap-major column matrix (each phase's rows are one
    block of it) and take one product each, with no product by an inserted
    zero; the phases are interleaved by one stack.  The decoder's
    ConvTranspose1d(k7, s2, p3, output_padding 1) is 3 taps for the even
    outputs and 4 for the odd.

Every product runs at the step's precision (``conv_matmul_precision``:
float32 in, float32 accumulation, TF32 off; bfloat16 operands with float32
accumulation at the bfloat16 compute dtype, each result rounded to
bfloat16 once, the bias inside the product).  The result is the (B, O, T)
tensor of ``F.conv1d`` as a transposed view of the (O, B*T) product.

The predicate ``batched`` is the contract: a CUDA tensor with cuDNN off
takes the form, whoever turned cuDNN off.  In this package only the GAN
steps do (``train/gan._float32``), so every call that takes the form is a
training convolution, and each adds one to the tracer's
``train.conv_batched``, the name the per-step readings use.

Everywhere else (a CPU tensor, or cuDNN on, as in inference) the functions
are ``F.conv1d`` and ``F.conv_transpose1d``.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.profiling import count


def batched(x) -> bool:
    """Whether a convolution of ``x`` takes the whole-batch form: a CUDA
    tensor with cuDNN off, where PyTorch would run its per-sample one."""
    return x.is_cuda and not torch.backends.cudnn.enabled


def conv1d(x, weight, bias=None, stride: int = 1, padding: int = 0):
    """``F.conv1d(x, weight, bias, stride, padding)`` of x (B, C, T) and
    weight (O, C, k)."""
    if not batched(x):
        return F.conv1d(x, weight, bias, stride, padding)
    count("train.conv_batched")
    return conv1d_gemm(x, weight, bias, stride, padding)


def conv_transpose1d(x, weight, bias=None, stride: int = 1, padding: int = 0,
                     output_padding: int = 0):
    """``F.conv_transpose1d(x, weight, bias, stride, padding,
    output_padding)`` of x (B, C, T) and weight (C, O, k)."""
    if not batched(x):
        return F.conv_transpose1d(x, weight, bias, stride, padding, output_padding)
    count("train.conv_batched")
    return conv_transpose1d_gemm(x, weight, bias, stride, padding, output_padding)


# the longest run of products one float32 output of the forward sums in order
CHUNK = 64


def _chunks(K: int) -> int:
    """The fewest equal parts of K no longer than CHUNK."""
    return next(s for s in range(-(-K // CHUNK), K + 1) if K % s == 0)


class _Product(torch.autograd.Function):
    """w2d (O, K) @ cols (K, N) plus the bias per row, its K summed in parts.

    One GEMM sums all K products of an output in one chain; on the GAN
    steps' widest layers (K = C*k up to 2,560) that left the generator's
    forward 2.7-3.3 times as far from float64 as PyTorch's per-sample
    products on an H100, with twice to three times as many pre-activations
    on the other side of a kink from float64's.
    So in float32 (and float64) the forward is one batched GEMM over the
    parts of K (at most CHUNK products each) and one sum over the parts.
    At bfloat16 one GEMM with float32 accumulation and the bias added
    inside it (``addmm``), so each output is rounded to bfloat16 once, as
    in PyTorch's own convolution: the parts, or a separate bias add, would
    round it again.  The backward is one GEMM for each gradient, reducing
    over N for the weight and over O for the columns, and one sum for the
    bias; at bfloat16 each GEMM under ``_float32_sums``."""

    @staticmethod
    def forward(ctx, w2d, cols, bias):
        ctx.save_for_backward(w2d, cols)
        ctx.bias = bias is not None
        O, K = w2d.shape
        if w2d.dtype == torch.bfloat16:
            with _float32_sums():
                return w2d @ cols if bias is None else torch.addmm(bias[:, None], w2d, cols)
        parts = _chunks(K)
        if parts == 1:
            y = w2d @ cols
        else:
            y = torch.bmm(w2d.view(O, parts, K // parts).transpose(0, 1),
                          cols.view(parts, K // parts, -1)).sum(0)
        return y if bias is None else y.add_(bias[:, None])

    @staticmethod
    def backward(ctx, g):
        w2d, cols = ctx.saved_tensors
        with _float32_sums() if g.dtype == torch.bfloat16 else contextlib.nullcontext():
            return (g @ cols.t() if ctx.needs_input_grad[0] else None,
                    w2d.t() @ g if ctx.needs_input_grad[1] else None,
                    g.sum(1) if ctx.bias else None)


@contextlib.contextmanager
def _float32_sums():
    """cuBLAS's bfloat16 GEMMs with their partial sums in float32.  PyTorch
    lets cuBLAS reduce them in bfloat16 by default
    (``allow_bf16_reduced_precision_reduction``); on an H100 that moves
    PyTorch's own bfloat16 convolution of a 252-channel k7 layer from
    7e-9 to 2.8e-4 of the sum of its products' magnitudes beyond the
    output's one rounding."""
    matmul = torch.backends.cuda.matmul
    was = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = was


def conv1d_gemm(x, weight, bias, stride, padding):
    """``conv1d`` as one product over the whole batch (on any device)."""
    B, C, _ = x.shape
    O, _, k = weight.shape
    u = F.pad(x, (padding, padding)).unfold(2, k, stride)  # (B, C, T_out, k)
    t_out = u.shape[2]
    cols = u.permute(1, 3, 0, 2).reshape(C * k, B * t_out)
    y = _Product.apply(weight.reshape(O, C * k), cols, bias)  # (O, B * T_out)
    return y.view(O, B, t_out).transpose(0, 1)


def conv_transpose1d_gemm(x, weight, bias, stride, padding, output_padding):
    """``conv_transpose1d`` as one product per output phase over the whole
    batch (on any device); every phase takes a tap (k >= stride)."""
    B, C, T = x.shape
    O, k, s, p = weight.shape[1], weight.shape[2], stride, padding
    length = (T - 1) * s - 2 * p + k + output_padding
    m = -(-length // s)  # outputs of each phase, the last ones cut below
    # phase r: y[s*i + r] = sum over taps j = r + p - s*q of x[i + q] w[:, :, j]
    taps = [range((r + p - k) // s + 1, (r + p) // s + 1) for r in range(s)]
    lo, hi = min(q[0] for q in taps), max(q[-1] for q in taps)
    left = max(0, -lo)
    right = max(0, m - 1 + hi - (T - 1))
    window = F.pad(x, (left, right))[:, :, lo + left:lo + left + m + hi - lo]
    cols = window.unfold(2, hi - lo + 1, 1)  # (B, C, m, hi - lo + 1)
    cols = cols.permute(3, 1, 0, 2).reshape((hi - lo + 1) * C, B * m)  # tap-major
    phases = []
    for r, qs in enumerate(taps):
        # taps j = r + p - s*q for q = qs[0], ..., qs[-1]: a strided slice, reversed
        w = weight[:, :, r + p - s * qs[-1]:r + p - s * qs[0] + 1:s].flip(2)
        w2d = w.permute(1, 2, 0).reshape(O, len(qs) * C)
        phases.append(_Product.apply(w2d, cols[(qs[0] - lo) * C:(qs[-1] - lo + 1) * C], bias))
    y = torch.stack(phases, dim=-1).view(O, B, m * s)[:, :, :length]
    return y.transpose(0, 1)
