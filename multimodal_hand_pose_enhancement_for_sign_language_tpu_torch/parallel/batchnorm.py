"""Train-mode BatchNorm over the global batch of a data-parallel step.

A jitted step of the JAX package over a batch sharded on 'data' computes
the BatchNorm statistics over the whole batch: XLA inserts the reduction.
Here it is written out as one ``autograd.Function`` over the mesh's data
group:

  * forward: each rank's (count, mean, M2) per channel, all-gathered and
    combined in rank order (Chan's parallel update, which keeps float32
    accuracy where a sum of squares would cancel), so every rank holds the
    same statistics; the running variance takes the global count's
    unbiased correction N / (N - 1),
  * backward: the per-channel sums of dy and dy * x_hat, all-reduced, give
    each rank the input gradient of the global loss for its rows; the
    weight and bias gradients stay local (the trainer's gradient all-reduce
    sums them).

A module converted by ``convert`` keeps ``nn.BatchNorm1d``'s keys and
eval-mode path; in train mode it pools over ``rows.group`` (a
``mesh.RowShard`` that the trainer sets per step) and, for a batch that is
not split (``group`` None), runs ``F.batch_norm`` on its local batch,
which is then the whole batch.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.parallel.mesh import (
    gather_rows,
)


def _dims(x):
    return [0] + list(range(2, x.dim()))


def _per_channel(v, x):
    return v.view(1, -1, *([1] * (x.dim() - 2)))


class _GlobalBatchNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        n_ranks = dist.get_world_size(group)
        xf = x.float()
        dims = _dims(x)
        n_local = x.numel() // x.shape[1]
        mean_l = xf.mean(dims)
        m2_l = torch.square(xf - _per_channel(mean_l, x)).sum(dims)
        stats = torch.stack((torch.full_like(mean_l, n_local), mean_l, m2_l))
        counts, means, m2s = gather_rows(stats, group, n_ranks).view(
            n_ranks, 3, -1).unbind(1)
        n = counts.sum(0)
        mean = (counts * means).sum(0) / n
        m2 = (m2s + counts * torch.square(means - mean)).sum(0)
        invstd = torch.rsqrt(m2 / n + eps)
        xhat = (xf - _per_channel(mean, x)) * _per_channel(invstd, x)
        ctx.save_for_backward(xhat, weight, invstd, n)
        ctx.group = group
        var = m2 / (n - 1)
        ctx.mark_non_differentiable(mean, var)
        y = xhat * _per_channel(weight.float(), x) + _per_channel(bias.float(), x)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        xhat, weight, invstd, n = ctx.saved_tensors
        dyf = dy.float()
        dims = _dims(dyf)
        sum_dy = dyf.sum(dims)
        sum_dy_xhat = (dyf * xhat).sum(dims)
        total = torch.stack((sum_dy, sum_dy_xhat))
        dist.all_reduce(total, group=ctx.group)
        dx = _per_channel(weight.float() * invstd, dyf) * (
            dyf - _per_channel(total[0] / n, dyf) - xhat * _per_channel(total[1] / n, dyf))
        return (dx.to(dy.dtype), sum_dy_xhat.to(weight.dtype), sum_dy.to(weight.dtype),
                None, None)


def batch_norm(x, running_mean, running_var, weight, bias, training: bool,
               momentum: float, eps: float, group=None):
    """``F.batch_norm``, with train-mode statistics pooled over ``group``
    when one is given; the running statistics are updated in place."""
    if not training or group is None:
        return F.batch_norm(x, running_mean, running_var, weight, bias, training,
                            momentum, eps)
    y, mean, var = _GlobalBatchNorm.apply(x, weight, bias, eps, group)
    with torch.no_grad():
        running_mean.mul_(1 - momentum).add_(mean.to(running_mean.dtype), alpha=momentum)
        running_var.mul_(1 - momentum).add_(var.to(running_var.dtype), alpha=momentum)
    return y


class DataParallelBatchNorm1d(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` whose train-mode statistics pool over
    ``self.rows.group``."""

    rows = None

    def forward(self, x):
        group = None if self.rows is None else self.rows.group
        if not self.training or group is None:
            return super().forward(x)
        self.num_batches_tracked.add_(1)
        return batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                          True, self.momentum, self.eps, group)


def convert(module: nn.Module, rows) -> nn.Module:
    """Make every ``nn.BatchNorm1d`` under ``module`` pool its train-mode
    statistics as ``rows`` (a ``mesh.RowShard``) says; keys and weights
    stay."""
    for m in module.modules():
        if type(m) is nn.BatchNorm1d:
            m.__class__ = DataParallelBatchNorm1d
        if isinstance(m, DataParallelBatchNorm1d):
            m.rows = rows
    return module
