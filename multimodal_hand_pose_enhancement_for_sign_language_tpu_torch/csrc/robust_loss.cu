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
// 4 B of loss and 4 B of dx; alpha and c are D floats each and stay in L2.
// The arithmetic is one powf or log1pf and a few divisions per element, far
// under the FP32 rate needed to keep up with 3.35 TB/s.  So the design is a
// flat grid-stride pass with neighbouring threads on neighbouring addresses;
// nothing is staged in shared memory, and the TPU kernel's 128-lane padding
// of D, 8-row blocks and sublane broadcast of alpha and c have no counterpart.
//
// powf, log1pf and the divisions are the accurate ones: the build passes no
// -use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 16;
constexpr int kSMs = 132;
constexpr float kEps = 1.1920928955078125e-07f;  // float32 machine epsilon

__global__ void __launch_bounds__(kThreads) robust_loss_kernel(
    const float* __restrict__ x, const float* __restrict__ alpha,
    const float* __restrict__ scale, float* __restrict__ loss,
    float* __restrict__ dx, long long n, long long D) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long col = i % D;
    const float xv = x[i];
    const float a = alpha[col];
    const float c = scale[col];
    const float xc = xv / c;
    const float u = xc * xc;
    const float x_cc = xv / (c * c);
    float l, d;
    if (a == 0.0f) {
      l = log1pf(fminf(0.5f * u, 33e37f));
      d = x_cc / (0.5f * u + 1.0f);
    } else if (a == 2.0f) {
      l = 0.5f * u;
      d = x_cc;
    } else {
      const float beta = fmaxf(kEps, fabsf(a - 2.0f));
      const float a_safe = (a >= 0.0f ? 1.0f : -1.0f) * fmaxf(kEps, fabsf(a));
      const float base = u / beta + 1.0f;
      const float p = powf(base, 0.5f * a);
      l = (beta / a_safe) * (p - 1.0f);
      d = x_cc * p / base;
    }
    loss[i] = l;
    dx[i] = d;
  }
}

}  // namespace

// C entry point (bound with ctypes).  x, loss and dx are contiguous float32
// (N, D) on one device; alpha and scale are contiguous float32 of D elements
// on the same device.  Returns the cudaError_t of the launch (0 on success);
// the kernel runs on `stream` and is not synchronised.
extern "C" int mhpe_robust_loss(const float* x, const float* alpha,
                                const float* scale, float* loss, float* dx,
                                long long N, long long D, void* stream) {
  if (N <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const long long n = N * D;
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = (long long)kSMs * kBlocksPerSM;
  if (blocks > cap) blocks = cap;
  robust_loss_kernel<<<(unsigned)blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(x, alpha, scale,
                                                            loss, dx, n, D);
  return (int)cudaGetLastError();
}
