"""Multi-host start-up under torchrun, and host-local batches.

PyTorch counterpart of the JAX package's ``parallel/multihost.py``:

  * ``initialize()`` -- the default process group from the environment
    ``python -m torch.distributed.run`` sets (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR, MASTER_PORT); False without it, so a plain run stays one
    process,
  * ``local_batch_slice(n)`` -- the [start, stop) rows of a global batch
    this process feeds,
  * ``global_batch_array(rows, mesh)`` -- a sharded batch from each rank's
    own rows, which the trainers' steps take like ``shard_batch``'s output,
  * ``device_for_rank()`` -- ``cuda:LOCAL_RANK``,
  * ``start`` / ``main_output_only`` / ``finish`` -- the CLIs' use of the
    above: a mesh over every rank, output and files from rank 0 only.

One process drives one device, so a process here is a rank of the mesh.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
import torch.distributed as dist

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.parallel.mesh import (
    Mesh,
    Sharded,
    _as_tensor,
    gather_rows,
    get_mesh,
)
from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils.device import (
    resolve_device,
)

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def device_for_rank(device="cuda") -> torch.device:
    """This process's device: ``cuda:LOCAL_RANK`` for CUDA, else the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def initialize(device="cuda") -> bool:
    """Start the default process group from torchrun's environment, on
    NCCL for a CUDA ``device`` (made current: ``cuda:LOCAL_RANK``) or gloo
    for the CPU.  Returns True once the group is up, whatever its size, and
    False without that environment.  Re-entry is fine; any other failure
    raises (carrying on as one process would train independent replicas)."""
    if not all(k in os.environ for k in _TORCHRUN_ENV):
        return False
    dev = device_for_rank(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return True
    try:
        dist.init_process_group(_BACKEND[dev.type], init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    except (RuntimeError, ValueError) as e:
        if "already" not in str(e).lower():
            raise
    return True


def is_main() -> bool:
    """Rank 0 (of the group, or of torchrun's environment before the group
    starts), or a lone process: the one that prints and writes."""
    if dist.is_initialized():
        return dist.get_rank() == 0
    return int(os.environ.get("RANK", 0)) == 0


def local_batch_slice(global_batch: int) -> slice:
    """Rows of the global batch this process owns (an equal split)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    i = dist.get_rank() if dist.is_initialized() else 0
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} must divide across {n} processes")
    per = global_batch // n
    return slice(i * per, (i + 1) * per)


def global_batch_array(local_rows, mesh: Mesh) -> Sharded:
    """This rank's rows (numpy or tensor, its block of the global batch in
    data-index order) as a sharded batch on the mesh's device.  Every rank
    of the data group must pass as many rows (checked: a collective)."""
    rows = _as_tensor(np.asarray(local_rows) if not torch.is_tensor(local_rows)
                      else local_rows, mesh.device)
    counts = gather_rows(torch.tensor([rows.shape[0]], device=mesh.device),
                         mesh.data_group, mesh.shape["data"])
    if len(set(counts.tolist())) != 1:
        raise ValueError(f"ranks hold unequal row counts {counts.tolist()}")
    return Sharded(rows)


def start(device="cuda"):
    """(mesh, device) for a CLI: under torchrun, the group started on
    ``device`` and a ``get_mesh()`` over all its ranks, whatever their
    number, on ``cuda:LOCAL_RANK`` (or the CPU); otherwise (None, device)."""
    if not initialize(device):
        return None, device
    mesh = get_mesh()
    mesh.check_device(device)
    return mesh, mesh.device


@contextlib.contextmanager
def main_output_only(mesh):
    """Silence standard output on every rank but 0."""
    if mesh is None or mesh.rank == 0:
        yield
        return
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        yield


def finish() -> None:
    """Tear the default process group down, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()
