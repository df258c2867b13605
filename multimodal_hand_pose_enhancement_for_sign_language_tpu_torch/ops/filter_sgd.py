"""The lifting filter's 900-cycle SGD: hand-written Hopper kernel + plain version.

Replaces the TPU kernel ``ops/pallas_kernels.py: filter_sgd`` of the JAX
package (``_filter_sgd_scaled`` -> ``pl.pallas_call`` of ``_filter_kernel``).
Contract as there: x0, y0, z0, tarx, tary, w are (B, T, 50) float32 planes,
mask is (B, T); returns the filtered (x, y, z) planes, each (B, T, 50).
Semantics are ``lifting/filtering.filter_xyz`` batched over clips.

* ``filter_sgd``: the wrapper.  A CPU tensor runs ``filter_sgd_plain``; a
  CUDA tensor launches ``csrc/filter_sgd.cu`` (built at first use by
  ``ops/build.py``) or raises.  ``filter_sgd.launches`` counts launches.
* ``filter_sgd_plain``: the ``filter_xyz`` loop in PyTorch, batched.

What bounds the kernel on an H100 is FP32 instruction issue on the CUDA
cores: 16 flops (``FLOPS_PER_ELEMENT_CYCLE``) per element per cycle, which
nvcc compiles to about 11 FP32 instructions (``build.loop_fp32_per_cycle``
counts them in the built library), against 36 B per element of device-memory
traffic for the whole call.  So the kernel keeps
every row's state in registers for all cycles, exchanges chunk edges by
warp shuffles (shared memory only every 8 cycles, between the warps of a
row longer than 256 steps) and runs no cycle on a warp that holds only
masked steps; ``launch_plan`` picks the layout (see the note in the CUDA
source).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops import build

J = 50
# x and y: (s - s1) * pm, a * s + b, - sd, + sd_prev = 6 flops each; z: 4
FLOPS_PER_ELEMENT_CYCLE = 16
# each of the six (B, T, 50) inputs read once, three outputs written once
BYTES_PER_ELEMENT = 36
_MAX_T = 4096
_K = 8  # steps a lane holds: 81-93 registers, no spills (K = 16 took 140-160)
_OWNED_LANES = 30  # lanes a warp owns in a row of several warps
_BLOCK_WARPS = 4  # warps in a block of one-warp rows


def filter_sgd_plain(x0, y0, z0, tarx, tary, w, mask, learning_rate: float,
                     n_cycles: int):
    """``filter_xyz`` (lifting/filtering.py:94-129) batched over clips."""
    n_points = x0.shape[2]
    t_real = mask.sum(dim=1)[:, None, None]  # (B, 1, 1)
    denom_data = t_real * n_points
    denom_smooth = (t_real - 1.0) * n_points
    wm = w * mask[:, :, None]
    pair = (mask[:, :-1] * mask[:, 1:])[:, :, None]  # (B, T-1, 1)

    def smooth_grad(s):
        d2 = 2.0 * ((s[:, :-1] - s[:, 1:]) * pair)
        # g[t] = 2 d[t] - 2 d[t-1] with zero ends
        return F.pad(d2, (0, 0, 0, 1)) - F.pad(d2, (0, 0, 1, 0))

    x, y, z = x0, y0, z0
    for _ in range(n_cycles):
        gx = 2.0 * wm * (x - tarx) / denom_data + smooth_grad(x) / denom_smooth
        gy = 2.0 * wm * (y - tary) / denom_data + smooth_grad(y) / denom_smooth
        gz = smooth_grad(z) / denom_smooth
        x = x - learning_rate * gx
        y = y - learning_rate * gy
        z = z - learning_rate * gz
    return x, y, z


def launch_plan(B: int, T: int) -> tuple:
    """(K, L, W, R) of the CUDA kernel for a (B, T) batch: K = 8 steps per
    lane, L lanes per row in a warp (a power of two, at most 32), W warps
    per row, R rows per block.  A row of T <= 32 K steps lives in L lanes of
    one warp (a warp packs 32 / L rows, a block 4 warps).  A longer row
    spans W warps, one row a block: lanes 1..30 of each warp own 30 K
    steps, lanes 0 and 31 hold halo copies of the neighbour warps' edges."""
    if T < 1 or T > _MAX_T:
        raise ValueError(f"filter_sgd: T={T} is outside the kernel's 1..{_MAX_T}")
    lanes = -(-T // _K)
    if lanes <= 32:
        L = 1 << (lanes - 1).bit_length()
        return _K, L, 1, 32 * _BLOCK_WARPS // L
    return _K, 32, -(-T // (_OWNED_LANES * _K)), 1


def _check(tensors, names, B, T):
    dev = tensors[0].device
    for t, n in zip(tensors, names):
        if t.device != dev:
            raise ValueError(f"filter_sgd: {n} is on {t.device}, x0 on {dev}")
        if t.dtype != torch.float32:
            raise ValueError(f"filter_sgd: {n} must be float32, got {t.dtype}")
        want = (B, T) if n == "mask" else (B, T, J)
        if tuple(t.shape) != want:
            raise ValueError(f"filter_sgd: {n} has shape {tuple(t.shape)}, want {want}")


def filter_sgd(x0, y0, z0, tarx, tary, w, mask, learning_rate: float,
               n_cycles: int):
    """Batched lifting filter; the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if x0.device.type == "cpu":
        return filter_sgd_plain(x0, y0, z0, tarx, tary, w, mask,
                                learning_rate, n_cycles)
    if x0.device.type != "cuda":
        raise ValueError(f"filter_sgd: unsupported device {x0.device}")
    B, T = mask.shape
    ins = (x0, y0, z0, tarx, tary, w, mask)
    _check(ins, ("x0", "y0", "z0", "tarx", "tary", "w", "mask"), B, T)
    if T > _MAX_T:
        raise ValueError(f"filter_sgd: T={T} exceeds the kernel's {_MAX_T}")
    ins = tuple(t.contiguous() for t in ins)
    outs = tuple(torch.empty_like(ins[0]) for _ in range(3))
    if B == 0 or T == 0:
        return outs
    fn = build.bind("filter_sgd", "mhpe_filter_sgd", [ctypes.c_void_p] * 10 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ])
    build.launch(fn, ins[0].device, *(t.data_ptr() for t in ins + outs),
                 B, T, float(learning_rate), int(n_cycles), *launch_plan(B, T))
    filter_sgd.launches += 1
    return outs


filter_sgd.launches = 0
