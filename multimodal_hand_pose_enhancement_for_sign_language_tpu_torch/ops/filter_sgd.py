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
cores: at least 16 flops (``FLOPS_PER_ELEMENT_CYCLE``) per element per
cycle, which the kernel writes as about 14 FP32 instructions so that each
step's increment is summed before it meets the state, as the plain version
sums it (``build.loop_fp32_per_cycle`` counts them in the built library),
against 36 B per element of device-memory traffic for the whole call.  So
the kernel keeps every row's state in registers for all cycles, exchanges chunk edges by
warp shuffles (shared memory only every 8 cycles, between the warps of a
row longer than 256 steps) and runs no cycle on a warp that holds only
masked steps; ``launch_plan`` picks the layout (see the note in the CUDA
source).  A row longer than 4320 steps (18 warps; a whole grouped video)
runs in segments of one block each, with 240 steps of halo on either side,
for at most 240 cycles a launch; the wrapper relaunches on a ping-pong
state buffer, ``ceil(n_cycles / 240)`` launches in all.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops import build

J = 50
# the least: x and y (s - s1) * pm, a * s + b, - sd, + sd_prev = 6 flops
# each; z 4
FLOPS_PER_ELEMENT_CYCLE = 16
# each of the six (B, T, 50) inputs read once, three outputs written once
BYTES_PER_ELEMENT = 36
_K = 8  # steps a lane holds: 81-93 registers, no spills (K = 16 took 140-160)
_OWNED_LANES = 30  # lanes a warp owns in a row of several warps
_BLOCK_WARPS = 4  # warps in a block of one-warp rows
_MAX_WARPS = 18  # warps in a block: 576 threads
# a longer row's segment has one warp's owned steps of halo on either side,
# and a launch runs that many cycles
_HALO = _OWNED_LANES * _K
_MAX_T_BLOCK = _MAX_WARPS * _HALO  # 4320: the longest row one block holds


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
    """The CUDA kernel's layout for a (B, T) batch: (K, L, W, R) for a row
    that one block holds, (K, L, W, R, G, H) for a longer one.  K = 8 steps
    per lane, L lanes per row in a warp (a power of two, at most 32), W
    warps per row, R rows per block.  A row of T <= 32 K steps lives in L
    lanes of one warp (a warp packs 32 / L rows, a block 4 warps).  A longer
    row spans W warps, one row a block: lanes 1..30 of each warp own 30 K
    steps, lanes 0 and 31 hold halo copies of the neighbour warps' edges.
    A row of more than 18 such warps (T > 4320) is cut into G segments of
    W - 2 owned warps, one block each, whose first and last warps hold the
    H = 30 K steps on either side; a launch runs at most H cycles."""
    if T < 1:
        raise ValueError(f"filter_sgd: T={T} is outside the kernel's range, T >= 1")
    lanes = -(-T // _K)
    if lanes <= 32:
        L = 1 << (lanes - 1).bit_length()
        return _K, L, 1, 32 * _BLOCK_WARPS // L
    if T <= _MAX_T_BLOCK:
        return _K, 32, -(-T // _HALO), 1
    G = -(-T // ((_MAX_WARPS - 2) * _HALO))
    return _K, 32, -(-T // (G * _HALO)) + 2, 1, G, _HALO


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
    ins = tuple(t.contiguous() for t in ins)
    outs = tuple(torch.empty_like(ins[0]) for _ in range(3))
    if B == 0 or T == 0:
        return outs
    fn = build.bind("filter_sgd", "mhpe_filter_sgd", [ctypes.c_void_p] * 10 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ])
    plan = launch_plan(B, T)
    if len(plan) == 6:
        # a segmented row: H cycles a launch, each launch from the state the
        # last one wrote; the last writes ``outs``, the one before a second
        # buffer, and so on back
        K, L, W, R, G, H = plan
        n_launch = max(1, -(-n_cycles // H))
    else:
        (K, L, W, R), G, H, n_launch = plan, 1, n_cycles, 1
    spare = (tuple(torch.empty_like(ins[0]) for _ in range(3))
             if n_launch > 1 else None)
    state = ins[:3]
    for i in range(n_launch):
        dst = outs if (n_launch - 1 - i) % 2 == 0 else spare
        build.launch(fn, ins[0].device,
                     *(t.data_ptr() for t in state + ins[3:] + dst), B, T,
                     float(learning_rate), int(min(H, n_cycles - i * H)), K, L, W, R, G)
        filter_sgd.launches += 1
        state = dst
    return outs


filter_sgd.launches = 0
