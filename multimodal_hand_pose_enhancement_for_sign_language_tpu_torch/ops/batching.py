"""Frame-flat batching for ragged lists of clips.

PyTorch counterpart of the JAX package's ``ops/batching.py``, without its
padding: XLA pads to keep one compiled shape per bucket, PyTorch needs none.
Frame-independent clip ops (every rotation conversion, FK and IK: each
output frame depends only on the same input frame) run through
``apply_clipwise``, which

  * lays the clips' frames end to end as one (F, D) array,
  * calls ``fn`` once per chunk of at most ``CHUNK_FRAMES`` frames, fewer
    for frames wider than 288 floats (a How2Sign partition, ~240K frames,
    is one call; a whole split a few),
  * splits the result back at the clips' offsets, as views of one array.

On a CUDA device the frames cross the bus through two page-locked buffers
of ``STAGE_BYTES`` each, made at the first such call and reused by every
later one: the host concatenates a chunk straight into the input buffer,
which is copied to the card without blocking; ``fn``'s result is copied
back without blocking into the output buffer (in pieces, should a wide
result not fit) and, after one synchronisation, into the call's ordinary
host array.  No result lives in page-locked memory.  On the CPU the flat
call is the whole path.

With the tracer on (``utils/profiling``) it counts ``convert.calls`` (calls
of ``fn``) and ``convert.staged_bytes`` (bytes through the page-locked
buffers, both ways).
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.utils import profiling

CHUNK_FRAMES = 1 << 18
# a chunk of the widest frame the conversions move: 48 bones' 6D rotations
STAGE_BYTES = CHUNK_FRAMES * 288 * 4

_STAGE_LOCK = threading.Lock()  # one call at a time fills the buffers
_stage: list = []  # [input buffer, output buffer], made at first use


def _pinned(which, shape):
    """A float32 view of ``shape`` at the start of page-locked buffer
    ``which`` (0 in, 1 out)."""
    if not _stage:
        _stage.extend(torch.empty(STAGE_BYTES, dtype=torch.uint8, pin_memory=True)
                      for _ in range(2))
    n = int(np.prod(shape, dtype=np.int64))
    return _stage[which][: 4 * n].view(torch.float32).view(shape)


def _frames(clips, offsets, a, b):
    """Views of frames [a, b) of the clips laid end to end."""
    first = int(np.searchsorted(offsets, a, side="right")) - 1
    last = int(np.searchsorted(offsets, b, side="left"))
    return [c[max(a - o, 0): b - o] for c, o in zip(clips[first:last], offsets[first:last])]


def _to_device(parts, device):
    """The parts concatenated, on ``device``; on CUDA through the page-locked
    input buffer, the copy left running."""
    if device.type != "cuda":
        return torch.from_numpy(np.concatenate(parts)).to(device)
    x = _pinned(0, (sum(len(p) for p in parts),) + parts[0].shape[1:])
    np.concatenate(parts, out=x.numpy())
    profiling.count("convert.staged_bytes", 4 * x.numel())
    return x.to(device, non_blocking=True)


def _to_host(y, out):
    """Copy ``y`` into the host array ``out``; on CUDA through the
    page-locked output buffer, in pieces that fit it."""
    if y.device.type != "cuda":
        out[...] = y.cpu().numpy()
        return
    row = int(np.prod(out.shape[1:], dtype=np.int64))
    step = max(STAGE_BYTES // max(4 * row, 1), 1)
    stream = torch.cuda.current_stream(y.device)
    for a in range(0, len(out), step):
        piece = y[a: a + step]
        pin = _pinned(1, piece.shape)
        pin.copy_(piece, non_blocking=True)
        stream.synchronize()
        torch.from_numpy(out[a: a + len(piece)]).copy_(pin)
        profiling.count("convert.staged_bytes", 4 * pin.numel())


def apply_clipwise(fn, clips, *args, device):
    """Apply ``fn(frames, *args) -> tensor`` to every (T_i, D) clip.

    ``fn`` takes an (F, D) float32 tensor on ``device`` and is
    frame-independent; ``args`` are passed unchanged to every call.  Returns
    a list of float32 numpy arrays with the original T_i leading dims, views
    of one array.
    """
    if len(clips) == 0:
        return []
    clips = [np.asarray(c, dtype=np.float32) for c in clips]
    offsets = np.cumsum([0] + [len(c) for c in clips])
    total = int(offsets[-1])
    # a chunk fills the input buffer at most, whatever the frame's width
    width = int(np.prod(clips[0].shape[1:], dtype=np.int64))
    chunk = min(CHUNK_FRAMES, STAGE_BYTES // max(4 * width, 1))
    device = torch.device(device)
    res = None
    with _STAGE_LOCK if device.type == "cuda" else contextlib.nullcontext():
        for a in range(0, max(total, 1), chunk):
            b = min(a + chunk, total)
            x = _to_device(_frames(clips, offsets, a, b) or clips[:1], device)
            profiling.count("convert.calls")
            y = fn(x, *args)
            if res is None:
                res = np.empty((total,) + tuple(y.shape[1:]), np.float32)
            _to_host(y, res[a:b])
    return np.split(res, offsets[1:-1])
