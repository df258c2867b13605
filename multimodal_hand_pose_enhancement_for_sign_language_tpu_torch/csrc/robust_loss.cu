// Barron's general robust loss rho(x, alpha, c) and d rho / dx, for Hopper.
//
// Replaces the TPU kernel multimodal_hand_pose_enhancement_for_sign_language_tpu/
// ops/pallas_kernels.py: lossfun_pallas -> _robust_fwd_pallas -> _robust_kernel.
// Same function, elementwise over an (N, D) residual with one alpha and one
// scale c per column.  With u = (x / c)^2, eps = float32 machine epsilon,
//
//     alpha == 0:  loss = log1p(min(u / 2, 33e37))       dx = (x / c^2) / (u / 2 + 1)
//     alpha == 2:  loss = u / 2                          dx = x / c^2
//     otherwise:   loss = (beta / a) (base^(alpha/2) - 1)  dx = (x / c^2) base^(alpha/2) / base
//
// where beta = max(eps, |alpha - 2|), a = sign(alpha) max(eps, |alpha|) and
// base = u / beta + 1.  The branches are chosen by exact comparison, as the
// TPU kernel chooses them; alpha must be finite (the +-inf closed forms of
// losses/robust/general.lossfun are not in the TPU kernel either).
//
// What bounds it on an H100: bytes.  Each element reads 4 B of x and writes
// 4 B of loss and 4 B of dx; alpha and c are D floats each.  The arithmetic
// is one powf or log1pf and a few divisions per element, far under the FP32
// rate needed to keep up with 3.35 TB/s.  So the design is one 2-D pass that
// spends its instructions on the elements:
//
//   * columns go across blockIdx.x * blockDim.x, four to a thread; rows are
//     walked from blockIdx.y in steps of gridDim.y, two rows at a time so
//     that two 16-byte loads are in flight.  No per-element index
//     arithmetic beyond a 64-bit row offset: no % and no division;
//   * x is read and loss and dx are written as float4 when D % 4 == 0 and
//     the three pointers are 16-byte aligned (the wrapper decides and says
//     which); otherwise the same pass runs on scalars with the ragged edge
//     masked;
//   * alpha and c are read once per thread, and c^2, beta, beta / a, alpha/2
//     and the branch are derived once per column and reused on every row.
//     Each is the value the per-element form computes (the same operations
//     on the same operands), so the results are unchanged.
//
// The TPU kernel's 128-lane padding of D, 8-row blocks and sublane broadcast
// of alpha and c have no counterpart.  powf, log1pf and the divisions are
// the accurate ones: the build passes no -use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kEps = 1.1920928955078125e-07f;  // float32 machine epsilon

// what one column needs, derived once from its alpha and c
struct Column {
  float c, cc, beta, ratio, half_alpha;
  int branch;  // 0: alpha == 0, 1: alpha == 2, 2: general
};

__device__ __forceinline__ Column column(float alpha, float c) {
  Column k;
  k.c = c;
  k.cc = c * c;
  k.beta = fmaxf(kEps, fabsf(alpha - 2.0f));
  const float a_safe =
      (alpha >= 0.0f ? 1.0f : -1.0f) * fmaxf(kEps, fabsf(alpha));
  k.ratio = k.beta / a_safe;
  k.half_alpha = 0.5f * alpha;
  k.branch = alpha == 0.0f ? 0 : (alpha == 2.0f ? 1 : 2);
  return k;
}

__device__ __forceinline__ void element(const Column& k, float xv, float& l,
                                        float& d) {
  const float xc = xv / k.c;
  const float u = xc * xc;
  const float x_cc = xv / k.cc;
  if (k.branch == 0) {
    l = log1pf(fminf(0.5f * u, 33e37f));
    d = x_cc / (0.5f * u + 1.0f);
  } else if (k.branch == 1) {
    l = 0.5f * u;
    d = x_cc;
  } else {
    const float base = u / k.beta + 1.0f;
    const float p = powf(base, k.half_alpha);
    l = k.ratio * (p - 1.0f);
    d = x_cc * p / base;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads) robust_loss_kernel(
    const float* __restrict__ x, const float* __restrict__ alpha,
    const float* __restrict__ scale, float* __restrict__ loss,
    float* __restrict__ dx, int N, int D) {
  const int col = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (col >= D) return;
  Column k[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    k[i] = col + i < D ? column(alpha[col + i], scale[col + i])
                       : column(2.0f, 1.0f);

  // one row: four elements from x into loss and dx
  auto one_row = [&](long long off, float4 xv) {
    float4 l, d;
    element(k[0], xv.x, l.x, d.x);
    element(k[1], xv.y, l.y, d.y);
    element(k[2], xv.z, l.z, d.z);
    element(k[3], xv.w, l.w, d.w);
    if constexpr (VEC) {
      *reinterpret_cast<float4*>(loss + off) = l;
      *reinterpret_cast<float4*>(dx + off) = d;
    } else {
      const float lv[4] = {l.x, l.y, l.z, l.w}, dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (col + i < D) {
          loss[off + i] = lv[i];
          dx[off + i] = dv[i];
        }
    }
  };
  auto load = [&](long long off) {
    if constexpr (VEC) {
      return *reinterpret_cast<const float4*>(x + off);
    } else {
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = col + i < D ? x[off + i] : 0.0f;
      return make_float4(v[0], v[1], v[2], v[3]);
    }
  };

  const int step = gridDim.y;
  int row = blockIdx.y;
  for (; row + step < N; row += 2 * step) {
    const long long off0 = (long long)row * D + col;
    const long long off1 = off0 + (long long)step * D;
    const float4 x0 = load(off0);
    const float4 x1 = load(off1);
    one_row(off0, x0);
    one_row(off1, x1);
  }
  if (row < N) {
    const long long off = (long long)row * D + col;
    one_row(off, load(off));
  }
}

}  // namespace

// C entry point (bound with ctypes).  x, loss and dx are contiguous float32
// (N, D) on one device; alpha and scale are contiguous float32 of D elements
// on the same device.  `vec` asks for the float4 pass: D % 4 == 0 and x,
// loss and dx 16-byte aligned, which is checked again here.  (gx, gy) is the
// host's launch_grid: gx blocks of 256 threads cover D four columns a thread,
// gy blocks walk the rows gy apart.  Returns the
// cudaError_t of the launch (0 on success); the kernel runs on `stream` and
// is not synchronised.
extern "C" int mhpe_robust_loss(const float* x, const float* alpha,
                                const float* scale, float* loss, float* dx,
                                int N, int D, int vec, int gx, int gy,
                                void* stream) {
  if (N <= 0 || D <= 0 || gy < 1 || gy > 65535 ||
      (long long)gx * kThreads * 4 < D)
    return (int)cudaErrorInvalidValue;
  if (vec && (D % 4 != 0 ||
              (((uintptr_t)x | (uintptr_t)loss | (uintptr_t)dx) & 15) != 0))
    return (int)cudaErrorMisalignedAddress;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    robust_loss_kernel<true><<<grid, kThreads, 0, s>>>(x, alpha, scale, loss,
                                                       dx, N, D);
  else
    robust_loss_kernel<false><<<grid, kThreads, 0, s>>>(x, alpha, scale, loss,
                                                        dx, N, D);
  return (int)cudaGetLastError();
}
