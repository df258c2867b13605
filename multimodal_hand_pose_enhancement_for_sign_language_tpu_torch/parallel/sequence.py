"""Sequence parallelism for the lifting filter: time sharded over ranks.

PyTorch counterpart of the JAX package's ``parallel/sequence.py``.  The
filter's smoothness term couples only adjacent frames, so a clip's time
axis shards over the ranks of a mesh axis with a one-frame halo exchange
per SGD cycle:

  * each rank owns a contiguous (T/n, nPoints) slab,
  * every cycle, neighbours exchange their boundary frames: the x, y and z
    rows packed into one (3, nPoints) message each way, sent and received
    in one ``dist.batch_isend_irecv`` so that no pair of ranks deadlocks
    (the JAX package's two ``lax.ppermute``\\s),
  * the data term is local; the loss denominators are the global T * 50
    and (T - 1) * 50.

There the 900 cycles compile into one program; here they are a loop of
plain PyTorch ops (no kernel of the port: the JAX function reaches no
``pallas_call``), on the mesh's device.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.parallel.mesh import (
    Mesh,
    _as_tensor,
    gather_rows,
)


def _axis(mesh: Mesh, axis_name: str):
    """(group, its ranks, this rank's index, size) of a mesh axis."""
    if axis_name == "data":
        return mesh.data_group, mesh.data_ranks, mesh.data_index, mesh.shape["data"]
    if axis_name == "model":
        return mesh.model_group, mesh.model_ranks, mesh.model_index, mesh.shape["model"]
    raise ValueError(f"unknown mesh axis {axis_name!r}")


def _exchange(s, group, prev, nxt, left, right):
    """Receive the previous rank's last rows into ``left`` and the next
    rank's first rows into ``right``; send ours the other way.  s (3, Tl, J)."""
    ops = []
    if prev is not None:
        ops += [dist.P2POp(dist.isend, s[:, 0].contiguous(), prev, group),
                dist.P2POp(dist.irecv, left, prev, group)]
    if nxt is not None:
        ops += [dist.P2POp(dist.isend, s[:, -1].contiguous(), nxt, group),
                dist.P2POp(dist.irecv, right, nxt, group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def filter_xyz_time_sharded(x0, y0, z0, tarx, tary, w, mesh: Mesh, axis_name: str = "data",
                            learning_rate: float = 20.0, n_cycles: int = 900):
    """Single-clip filtering with the TIME axis sharded over a mesh axis.

    All inputs (T, nPoints), numpy or tensors, held whole by every rank,
    with T divisible by the axis size.  Semantics of
    ``lifting.filtering.filter_xyz`` on a full-length clip (no mask).
    Returns the filtered (x, y, z), each (T, nPoints), whole on every rank,
    on the mesh's device."""
    group, ranks, idx, n = _axis(mesh, axis_name)
    T, J = x0.shape
    if T % n:
        raise ValueError(f"T={T} does not divide over {n} ranks of {axis_name!r}")
    per = T // n
    x, y, z, tx, ty, ww = (_as_tensor(a, mesh.device)[idx * per:(idx + 1) * per].float()
                           for a in (x0, y0, z0, tarx, tary, w))
    s = torch.stack((x, y, z))  # (3, Tl, J)
    tar = torch.stack((tx, ty, torch.zeros_like(tx)))
    wd = torch.stack((ww, ww, torch.zeros_like(ww))) * (2.0 / (T * J))
    denom_smooth = float((T - 1) * J)
    prev = ranks[idx - 1] if idx > 0 else None
    nxt = ranks[idx + 1] if idx < n - 1 else None
    left = torch.zeros((3, J), dtype=s.dtype, device=s.device)
    right = torch.zeros_like(left)
    for _ in range(n_cycles):
        _exchange(s, group, prev, nxt, left, right)
        d = s - torch.cat((s[:, 1:], right[:, None]), dim=1)  # d_t = s_t - s_{t+1}
        if nxt is None:  # the chain's last frame has no (T-1 -> T) pair
            d[:, -1] = 0.0
        # d_{t-1}; the first row's lives upstream (zero at the chain's start)
        d_first = (left - s[:, 0]) if prev is not None else torch.zeros_like(left)
        d_prev = torch.cat((d_first[:, None], d[:, :-1]), dim=1)
        g = wd * (s - tar) + (2.0 * d - 2.0 * d_prev) / denom_smooth
        s = s - learning_rate * g
    full = gather_rows(s.transpose(0, 1), group, n)  # (T, 3, J)
    return tuple(full.unbind(1))
