"""Mesh construction, batch sharding and tensor parallelism over torch.distributed.

PyTorch counterpart of the JAX package's ``parallel/mesh.py``.  There one
process holds a ``jax.sharding.Mesh`` and ``jit`` over sharded arrays lets
XLA insert every collective.  PyTorch runs one process per device, so the
collectives are written out here and in their callers:

  * a ``Mesh`` is a (data, model) grid over the ranks of the default
    process group, rank r at (r // model, r % model), with the subgroup
    along each axis,
  * ``shard_batch`` gives this rank its rows of a global batch that every
    rank holds (as the CLIs load it), ``replicate`` broadcasts modules or
    tensors from the first rank of each group,
  * ``tp_param_placement`` keeps this rank's slice of the output channels
    of every convolution of the generator (the JAX function's 3-D leaves);
    the convolution then runs as ``act_constraint`` makes XLA run it: an
    identity forward whose input gradient is all-reduced over 'model',
    the local output channels, an all-gather of them whose backward takes
    this rank's slice.  ``tp_full_state_dict`` gathers the reference
    layout back, so checkpoints load with ``strict=True``.

The device follows the backend: NCCL for CUDA tensors, gloo for CPU
tensors; a caller whose device is not the mesh's is refused
(``Mesh.check_device``), never switched.  Every collective runs whatever the size of its
group, so a one-rank group exercises the same calls as a larger one.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.models import layers
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops import conv

class Mesh:
    """A (data, model) grid over the ranks of the default process group.

    ``shape`` {'data': D, 'model': M}; ``rank`` the global rank, at
    (``data_index``, ``model_index``) = (rank // M, rank % M);
    ``data_group`` the D ranks that share this rank's model index (batch
    rows split over them), ``model_group`` the M ranks that share its data
    index (output channels split over them); ``device`` the device of this
    rank's tensors."""

    def __init__(self, data: int, model: int, device):
        self.shape = {"data": data, "model": model}
        self.rank = dist.get_rank()
        self.data_index, self.model_index = divmod(self.rank, model)
        self.device = torch.device(device)
        # every rank creates every group, in the same order
        self.data_ranks = self.model_ranks = None
        self.data_group = self.model_group = None
        for m in range(model):
            ranks = [d * model + m for d in range(data)]
            group = dist.new_group(ranks)
            if m == self.model_index:
                self.data_ranks, self.data_group = ranks, group
        for d in range(data):
            ranks = [d * model + m for m in range(model)]
            group = dist.new_group(ranks)
            if d == self.data_index:
                self.model_ranks, self.model_group = ranks, group

    def __repr__(self):
        return (f"Mesh(data={self.shape['data']}, model={self.shape['model']}, "
                f"rank={self.rank}, device={self.device})")

    def check_device(self, device) -> None:
        """Refuse a caller's device that is not this mesh's."""
        device = torch.device(device)
        if device.type != self.device.type:
            raise ValueError(f"device {device} does not match the mesh's {self.device}")


def get_mesh(n_devices: Optional[int] = None, model_axis: int = 1) -> Mesh:
    """Build a ('data', 'model') mesh over the ranks of the default process
    group (``multihost.initialize`` or ``dist.init_process_group`` first).

    ``n_devices`` must be the group's size when given; ``model_axis`` must
    divide it.  The mesh's device follows the group's backend: the current
    CUDA device under NCCL, the CPU under gloo."""
    if not dist.is_initialized():
        raise RuntimeError("get_mesh needs an initialized default process group")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"n_devices {n}: the process group has {world} ranks")
    if model_axis < 1 or n % model_axis:
        raise ValueError(f"model_axis {model_axis} does not divide {n} ranks")
    backend = str(dist.get_backend())
    if "nccl" in backend:
        device = torch.device("cuda", torch.cuda.current_device())
    elif "gloo" in backend:
        device = torch.device("cpu")
    else:
        raise ValueError(f"no mesh over the {backend!r} backend: NCCL or gloo")
    return Mesh(n // model_axis, model_axis, device)


def pad_to_multiple(n: int, k: int) -> int:
    return int(math.ceil(n / k) * k)


# ----------------------------------------------------------------------
# batches
# ----------------------------------------------------------------------
@dataclass
class Sharded:
    """This rank's rows of a batch split along 'data', on the mesh's device."""
    rows: torch.Tensor


def _as_tensor(x, device):
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def shard_batch(x, mesh: Mesh) -> Sharded:
    """This rank's rows of a global batch (numpy or tensor) that every rank
    holds, on the mesh's device; the leading axis must divide 'data'."""
    n, d = x.shape[0], mesh.shape["data"]
    if n % d:
        raise ValueError(f"batch of {n} rows does not divide over data={d}")
    per = n // d
    i = mesh.data_index
    return Sharded(_as_tensor(x[i * per:(i + 1) * per], mesh.device))


class RowShard:
    """How a step's batch lies over the mesh, shared by the modules'
    ``Dropout`` and BatchNorm layers: ``index``/``count`` this rank's block
    of the global batch's rows (0/1 for a replicated batch), ``group`` the
    data group whose statistics a train-mode BatchNorm pools (None: the
    local batch is the whole batch)."""

    def __init__(self):
        self.set(None)

    def set(self, mesh: Optional[Mesh]) -> None:
        """Rows sharded over ``mesh``'s data axis, or (None) replicated."""
        self.index = 0 if mesh is None else mesh.data_index
        self.count = 1 if mesh is None else mesh.shape["data"]
        self.group = None if mesh is None else mesh.data_group


def local_rows(arrays, mesh: Mesh):
    """(this rank's rows of each array, sharded?) for a step's batch.
    ``Sharded`` inputs give their rows; tensors whose rows divide 'data' are
    sliced; otherwise every array stays whole (replicated), as the JAX
    trainer replicates a batch that does not divide.  None stays None."""
    given = [a for a in arrays if a is not None]
    if any(isinstance(a, Sharded) for a in given):
        if not all(isinstance(a, Sharded) for a in given):
            raise ValueError("a step's arrays must all be sharded or all be whole")
        return [None if a is None else a.rows for a in arrays], True
    if given[0].shape[0] % mesh.shape["data"]:
        return list(arrays), False
    return [None if a is None else shard_batch(a, mesh).rows for a in arrays], True


def gather_rows(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """All-gather equal-sized row blocks of the ``n`` ranks of ``group``,
    concatenated in rank order."""
    t = t.contiguous()
    out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    # all_gather_single is all_gather_into_tensor's newer name
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, t, group=group)
    return out


def all_reduce_mean(bucket: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Mean over the data group, in place."""
    dist.all_reduce(bucket, group=mesh.data_group)
    return bucket.div_(mesh.shape["data"])


def _broadcast(tensors, ranks, group) -> None:
    for t in tensors:
        dist.broadcast(t.data, src=ranks[0], group=group)


def replicate(obj, mesh: Mesh):
    """Broadcast a module's parameters and buffers (or a list of tensors)
    from the first rank of each data group, then of each model group.  A
    parameter that ``tp_param_placement`` split keeps its own slice: it is
    broadcast over the data group only."""
    if isinstance(obj, nn.Module):
        split = {id(m.weight) for m in obj.modules() if hasattr(m, "tp_dim")}
        tensors = list(obj.parameters()) + list(obj.buffers())
    else:
        split, tensors = set(), list(obj)
    with torch.no_grad():
        _broadcast(tensors, mesh.data_ranks, mesh.data_group)
        _broadcast([t for t in tensors if id(t) not in split], mesh.model_ranks,
                   mesh.model_group)
    return obj


# ----------------------------------------------------------------------
# tensor parallelism over 'model'
# ----------------------------------------------------------------------
class _CopyToModel(torch.autograd.Function):
    """Identity forward; the input gradient summed over the model group
    (each rank's slice of output channels contributes its part)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherChannels(torch.autograd.Function):
    """(B, C/M, ...) -> (B, C, ...): all-gather over the model group along
    the channels; the backward keeps this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, y, group, index, count):
        ctx.index, ctx.c = index, y.shape[1]
        out = gather_rows(y.movedim(1, 0), group, count)  # (C, B, ...)
        return out.movedim(0, 1).contiguous()

    @staticmethod
    def backward(ctx, g):
        return g[:, ctx.index * ctx.c:(ctx.index + 1) * ctx.c], None, None, None


def _tp_conv(self, x, conv):
    x = _CopyToModel.apply(x, self.tp_mesh.model_group)
    y = conv(x, self.weight)
    y = _GatherChannels.apply(y, self.tp_mesh.model_group, self.tp_mesh.model_index,
                              self.tp_mesh.shape["model"])
    return y + self.bias.view(1, -1, *([1] * (y.dim() - 2)))


class TPConv1d(layers.Conv1d):
    """``layers.Conv1d`` holding this rank's output channels (weight dim 0)."""
    tp_dim = 0

    def forward(self, x):
        return _tp_conv(self, x, lambda x, w: conv.conv1d(
            x, w, None, self.stride[0], self.padding[0]))


class TPConvTranspose1d(layers.ConvTranspose1d):
    """``layers.ConvTranspose1d`` holding this rank's output channels
    (weight dim 1)."""
    tp_dim = 1

    def forward(self, x):
        return _tp_conv(self, x, lambda x, w: conv.conv_transpose1d(
            x, w, None, self.stride[0], self.padding[0], self.output_padding[0]))


_TP_CLASSES = {layers.Conv1d: TPConv1d, layers.ConvTranspose1d: TPConvTranspose1d}


def local_split(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """This model rank's slice of a whole tensor along ``dim``."""
    c = t.shape[dim] // mesh.shape["model"]
    return t.narrow(dim, mesh.model_index * c, c)


def tp_param_placement(generator: nn.Module, mesh: Mesh) -> list:
    """Split every convolution of ``generator`` whose output channels divide
    'model' over the model group: this rank keeps its slice of the weight
    (torch's Conv1d (out, in, k) on dim 0, ConvTranspose1d (in, out, k) on
    dim 1); biases stay whole, as the JAX function places only the 3-D
    kernels.  Call before building the optimizer.  Returns the split
    modules' names."""
    model = mesh.shape["model"]
    names = []
    for name, m in generator.named_modules():
        cls = _TP_CLASSES.get(type(m))
        if cls is None or m.out_channels % model:
            continue
        m.__class__ = cls
        m.tp_mesh = mesh
        with torch.no_grad():
            m.weight = nn.Parameter(local_split(m.weight, cls.tp_dim, mesh).clone())
        names.append(name)
    return names


def _split_keys(module: nn.Module) -> dict:
    """{state_dict key: split dim} of the module's split weights."""
    return {f"{name}.weight": m.tp_dim for name, m in module.named_modules()
            if hasattr(m, "tp_dim")}


def gather_split(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from each model rank's slice along ``dim``."""
    return gather_rows(t.movedim(dim, 0), mesh.model_group,
                       mesh.shape["model"]).movedim(0, dim).contiguous()


def tp_full_state_dict(module: nn.Module, mesh: Mesh) -> dict:
    """``module.state_dict()`` with every split weight gathered: the
    reference layout (a collective over the model group)."""
    sd = module.state_dict()
    for key, dim in _split_keys(module).items():
        sd[key] = gather_split(sd[key], dim, mesh)
    return sd


def tp_local_state_dict(state_dict: dict, module: nn.Module, mesh: Mesh) -> dict:
    """A reference-layout state dict cut to this rank's slices of
    ``module``'s split weights, for ``load_state_dict(strict=True)``."""
    sd = dict(state_dict)
    for key, dim in _split_keys(module).items():
        sd[key] = local_split(sd[key], dim, mesh).clone()
    return sd
