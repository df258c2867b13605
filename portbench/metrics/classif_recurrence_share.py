"""Share of the traced cycle's device busy time spent in cuDNN's LSTM
recurrence: the kernels launched once a timestep, layer and direction, over
the union of all device intervals (``Trace.busy_s``).  None when no kernel
matches, never 0.

The names, as the traces of this cell show them on an H100 (torch 2.11,
CUDA 12.8): cuDNN's per-timestep cell kernels carry ``RNN`` or ``LSTM``
(``elemWiseRNNcell``, ``LSTM_elementWise_bp1``,
``GENERIC_elementWise_bp2<..., cudnnRNNBiasMode_t>``,
``RNN_bidirectional_accum_bp1_1``); its per-timestep products h W_hh^T run as
``sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8`` (forward) and
``cutlass_80_simt_sgemm_64x64_8x5_nn`` (backward), 3,840 launches a forward
or backward.  The cell's other products (the input projections over all
timesteps, the weight gradients, the head) run as larger tiles
(``sgemm_256x128``, ``sgemm_128x256``, ``tilesize128x64x8``); of the 64x64
forward kernel's 26,886 launches a traced cycle, 6 are not the recurrence.
"""

PARTS = ("RNN", "LSTM", "tilesize64x64x8", "simt_sgemm_64x64_")


def read(r):
    if r.trace is None or r.trace.busy_s <= 0:
        return None
    names = [k for k in r.trace.kernel_s if any(p in k for p in PARTS)]
    if not names:
        return None
    return 100.0 * sum(r.trace.kernel_s[k] for k in names) / r.trace.busy_s
