"""Shape-bucketed batching for ragged lists of clips.

PyTorch counterpart of the JAX package's ``ops/batching.py``.  Frame-
independent clip ops run through ``apply_clipwise``, which

  * pads each clip's time axis up to the next multiple of ``t_bucket``
    (edge-replicating the last frame, so no Inf/NaN garbage is computed),
  * groups clips by padded length and pads the batch axis up to the next
    power of two (repeating the first clip),
  * runs one batched call per (batch bucket, T bucket) on the device,
  * slices the results back to the original lengths.

Valid only for ops where each output frame depends solely on the same
input frame (every rotation conversion, FK and IK).
"""

from __future__ import annotations

import numpy as np
import torch


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _bucket_len(t: int, t_bucket: int) -> int:
    return ((t + t_bucket - 1) // t_bucket) * t_bucket


def apply_clipwise(fn, clips, *args, device, t_bucket: int = 64,
                   dtype=np.float32, max_batch: int = 1024):
    """Apply ``fn(batch, *args) -> tensor`` to every (T_i, D) clip.

    ``fn`` takes a (B, T, D) tensor on ``device`` and is frame-independent;
    ``args`` are passed unchanged to every call.  Returns a list of numpy
    arrays with the original T_i leading dims.  ``max_batch`` bounds one
    call's clip count, so an article-scale group never materializes a
    multi-GB padded stack at once.
    """
    if len(clips) == 0:
        return []
    groups: dict = {}
    for i, c in enumerate(clips):
        c = np.asarray(c, dtype=dtype)
        tb = _bucket_len(max(c.shape[0], 1), t_bucket)
        groups.setdefault((tb, c.shape[1:]), []).append((i, c))

    out = [None] * len(clips)
    for (tb, feat_shape), members in groups.items():
        for start in range(0, len(members), max_batch):
            chunk = members[start : start + max_batch]
            n = len(chunk)
            nb = _next_pow2(n)
            stack = np.empty((nb, tb) + feat_shape, dtype=dtype)
            for slot, (i, c) in enumerate(chunk):
                stack[slot, : c.shape[0]] = c
                if c.shape[0] < tb:  # edge-pad with the last frame
                    stack[slot, c.shape[0] :] = c[-1]
            for slot in range(n, nb):  # batch padding: repeat the first clip
                stack[slot] = stack[0]
            res = fn(torch.from_numpy(stack).to(device), *args).cpu().numpy()
            for slot, (i, c) in enumerate(chunk):
                out[i] = res[slot, : c.shape[0]]
    return out
