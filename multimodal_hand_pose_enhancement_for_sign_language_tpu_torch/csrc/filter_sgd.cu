// Lifting filter: n_cycles SGD steps of direct xyz smoothing, for Hopper.
//
// Replaces the TPU kernel multimodal_hand_pose_enhancement_for_sign_language_tpu/
// ops/pallas_kernels.py: filter_sgd -> _filter_sgd_scaled -> _filter_kernel.
// Same function as lifting/filtering.filter_xyz batched over clips: for every
// (clip b, joint j) row, independently, and every cycle
//
//     sd[t] = (s[t] - s[t+1]) * pm[t]                 (pm[t] = 0 at t >= t_real-1)
//     s[t]  = a[t] * s[t] + b[t] - sd[t] + sd[t-1]     (sd[-1] = 0)
//
// for s in {x, y, z}, with a = 1 - lw2, b = lw2 * target, lw2 = 2 lr w mask /
// (t_real J), pm = 2 lr mask[t] mask[t+1] / ((t_real - 1) J).  z has no data
// term (a = 1, b = 0).  The coefficients are folded here from the raw inputs
// (x0, y0, z0, tarx, tary, w, mask), so each input is read once and each
// output written once.
//
// What bounds it on an H100: FP32 arithmetic on the CUDA cores.  Per element
// and cycle it does 16 flops (6 for x, 6 for y, 4 for z, an FMA counted as 2);
// device-memory traffic is 36 B per element plus the mask, once, against
// 16 * n_cycles flops (14,400 at the production 900 cycles).  So the design
// keeps the whole state on chip for all cycles:
//
//   * one row is split over P threads, each holding K consecutive time steps
//     of x, y, z and their folded coefficients in registers;
//   * the only traffic per cycle is each thread's two edge values per
//     coordinate, swapped through a double-buffered shared-memory slot with
//     ONE __syncthreads: every sd is computed from the old state (the right
//     neighbour s[t+1] and the left neighbour s[t-1] are both read from the
//     buffer written before the barrier), and the parity flip keeps cycle c+1
//     from overwriting what a slow thread still reads in cycle c;
//   * rows are independent, so a block packs R = 256 / P rows and there is no
//     inter-block communication; the TPU kernel's 128-lane time padding,
//     chunk rescale, batch segmentation and VMEM budget have no counterpart.
//
// The time edges are explicit zeros rather than the TPU kernel's wrap-around
// roll.  nvcc contracts a*s+b into an FMA; the plain PyTorch version keeps the
// unfolded gradient form, so the two agree to rounding (2e-4 at 900 cycles is
// the stated tolerance).

#include <cuda_runtime.h>

namespace {

constexpr int kJoints = 50;
constexpr int kRowThreads = 256;  // threads a block aims for
constexpr int kMaxThreads = 512;  // one row of P <= 512 chunks

template <int K>
__global__ void __launch_bounds__(kMaxThreads) filter_sgd_kernel(
    const float* __restrict__ x0, const float* __restrict__ y0,
    const float* __restrict__ z0, const float* __restrict__ tarx,
    const float* __restrict__ tary, const float* __restrict__ w,
    const float* __restrict__ mask, float* __restrict__ xo,
    float* __restrict__ yo, float* __restrict__ zo, int B, int T, int P, int R,
    float lr, int n_cycles) {
  // edge[parity][c][thread]: c = 0..2 first x/y/z of the chunk, 3..5 last
  __shared__ float edge[2][6][kMaxThreads];
  __shared__ float t_real_s[kMaxThreads];

  const int tid = threadIdx.x;
  const int r = tid % R;  // row within the block
  const int p = tid / R;  // chunk within the row
  const long long row = (long long)blockIdx.x * R + r;
  const bool row_ok = row < (long long)B * kJoints;
  const int b = row_ok ? (int)(row / kJoints) : 0;
  const int j = (int)(row % kJoints);
  const int t0 = p * K;  // P = ceil(T / K), so t0 < T
  const float* m = mask + (long long)b * T;

  // valid-frame count of the row's clip: 0/1 partial sums are exact in f32,
  // so the atomic order cannot change the result
  if (tid < R) t_real_s[tid] = 0.f;
  __syncthreads();
  float cnt = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (t0 + k < T) cnt += m[t0 + k];
  if (row_ok) atomicAdd(&t_real_s[r], cnt);
  __syncthreads();
  const float t_real = t_real_s[r];
  const float c_data = 2.f * lr / (t_real * (float)kJoints);
  const float c_pair = 2.f * lr / ((t_real - 1.f) * (float)kJoints);

  float sx[K], sy[K], sz[K], a[K], bx[K], by[K], pm[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int t = t0 + k;
    if (row_ok && t < T) {
      const long long idx = ((long long)b * T + t) * kJoints + j;
      const float mt = m[t];
      const float lw2 = c_data * w[idx] * mt;
      sx[k] = x0[idx];
      sy[k] = y0[idx];
      sz[k] = z0[idx];
      a[k] = 1.f - lw2;
      bx[k] = lw2 * tarx[idx];
      by[k] = lw2 * tary[idx];
      pm[k] = (t + 1 < T) ? mt * m[t + 1] * c_pair : 0.f;
    } else {
      sx[k] = sy[k] = sz[k] = 0.f;
      a[k] = 1.f;
      bx[k] = by[k] = pm[k] = 0.f;
    }
  }
  // pair (t0-1, t0) belongs to the left neighbour; its sd enters s[t0]
  const float pm_left = (row_ok && p > 0) ? m[t0 - 1] * m[t0] * c_pair : 0.f;

  for (int c = 0; c < n_cycles; ++c) {
    const int par = c & 1;
    edge[par][0][tid] = sx[0];
    edge[par][1][tid] = sy[0];
    edge[par][2][tid] = sz[0];
    edge[par][3][tid] = sx[K - 1];
    edge[par][4][tid] = sy[K - 1];
    edge[par][5][tid] = sz[K - 1];
    __syncthreads();
    float dlx = 0.f, dly = 0.f, dlz = 0.f;
    if (p > 0) {
      dlx = (edge[par][3][tid - R] - sx[0]) * pm_left;
      dly = (edge[par][4][tid - R] - sy[0]) * pm_left;
      dlz = (edge[par][5][tid - R] - sz[0]) * pm_left;
    }
    float rx = 0.f, ry = 0.f, rz = 0.f;
    if (p < P - 1) {
      rx = edge[par][0][tid + R];
      ry = edge[par][1][tid + R];
      rz = edge[par][2][tid + R];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      // s[k+1] is still the old value: the sweep goes up in k
      const float nx = (k < K - 1) ? sx[k + 1] : rx;
      const float ny = (k < K - 1) ? sy[k + 1] : ry;
      const float nz = (k < K - 1) ? sz[k + 1] : rz;
      const float dx = (sx[k] - nx) * pm[k];
      const float dy = (sy[k] - ny) * pm[k];
      const float dz = (sz[k] - nz) * pm[k];
      sx[k] = a[k] * sx[k] + bx[k] - dx + dlx;
      sy[k] = a[k] * sy[k] + by[k] - dy + dly;
      sz[k] = sz[k] - dz + dlz;
      dlx = dx;
      dly = dy;
      dlz = dz;
    }
  }

  if (!row_ok) return;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int t = t0 + k;
    if (t < T) {
      const long long idx = ((long long)b * T + t) * kJoints + j;
      xo[idx] = sx[k];
      yo[idx] = sy[k];
      zo[idx] = sz[k];
    }
  }
}

template <int K>
cudaError_t launch(const float* x0, const float* y0, const float* z0,
                   const float* tarx, const float* tary, const float* w,
                   const float* mask, float* xo, float* yo, float* zo, int B,
                   int T, float lr, int n_cycles, cudaStream_t stream) {
  const int P = (T + K - 1) / K;
  if (P > kMaxThreads) return cudaErrorInvalidValue;
  const int R = P >= kRowThreads ? 1 : kRowThreads / P;
  const long long rows = (long long)B * kJoints;
  const long long blocks = (rows + R - 1) / R;
  filter_sgd_kernel<K><<<(unsigned)blocks, R * P, 0, stream>>>(
      x0, y0, z0, tarx, tary, w, mask, xo, yo, zo, B, T, P, R, lr, n_cycles);
  return cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes).  All tensors are contiguous float32 on
// one device: seven (B, T, 50) planes and a (B, T) mask in, three (B, T, 50)
// planes out.  `k` is the time steps per thread (1, 2, 4 or 8).  Returns the
// cudaError_t of the launch (0 on success); the kernel runs on `stream` and is
// not synchronised.
extern "C" int mhpe_filter_sgd(const float* x0, const float* y0,
                               const float* z0, const float* tarx,
                               const float* tary, const float* w,
                               const float* mask, float* xo, float* yo,
                               float* zo, int B, int T, float lr, int n_cycles,
                               int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1:
      return launch<1>(x0, y0, z0, tarx, tary, w, mask, xo, yo, zo, B, T, lr,
                       n_cycles, s);
    case 2:
      return launch<2>(x0, y0, z0, tarx, tary, w, mask, xo, yo, zo, B, T, lr,
                       n_cycles, s);
    case 4:
      return launch<4>(x0, y0, z0, tarx, tary, w, mask, xo, yo, zo, B, T, lr,
                       n_cycles, s);
    case 8:
      return launch<8>(x0, y0, z0, tarx, tary, w, mask, xo, yo, zo, B, T, lr,
                       n_cycles, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
