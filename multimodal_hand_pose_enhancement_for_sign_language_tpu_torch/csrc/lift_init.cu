// The lifting's initialisation: the walk along the 49-bone tree, per frame,
// for Hopper.
//
// Replaces no Pallas kernel.  It stands for the JAX package's XLA-compiled
// lax.scan over the bones (multimodal_hand_pose_enhancement_for_sign_language_tpu/
// lifting/init3d.py: initialization, and lifting/filtering.py: fk_from_angles),
// which eager PyTorch runs as ~15K small launches a batch
// (lifting/init3d.walk_bones and lifting/filtering.forward_kinematics, the
// plain version in ops/lift_init.py).  One thread per (clip, frame) runs the
// bones in order (the tree's order: bone i ends at joint i + 1) and, for each:
//
//   1. compute_b's five hypotheses for the direction from the start joint
//      towards the 2D target, the first minimum of the reprojection error
//      winning (strict <), and the reference's rule that a non-finite error of
//      the first hypothesis keeps it;
//   2. the guards: non-finite components to 0, an all-zero direction to
//      (1, 1, 1), z to |z| + 0.001, then the normalisation;
//   3. the anchor  Y[b] = Y[a] + L g;
//   4. forward kinematics  P[b] = P[a] + L g / (||g|| + 1e-10),  written out
//      as x0, y0, z0.
//
// The result must equal the plain op stream on the card bit for bit: the
// chain is ill-conditioned in z (one ulp of a bone length moves z by ~1e-3),
// so a hypothesis chosen differently is another result.  Every PyTorch op of
// the plain version is one IEEE-rounded operation (x**2 is x*x, x**3 is
// x*x*x, **0.5 is a correctly rounded sqrt, 1.0 / t a reciprocal times 1.0,
// / a correctly rounded division), so each step here is written with the
// round-to-nearest intrinsics, which nvcc never contracts into an FMA, in the
// order Python evaluates the plain version's expressions.
//
// What bounds it on an H100: per frame ~1 KB of device memory (Xx and Xy
// read, x0, y0 and z0 written) against ~9.7K flops, but a quarter of them
// divisions and square roots, which the correctly rounded forms issue as
// several instructions each; so instruction issue bounds it, ~20K a frame,
// more than the bytes.  The design keeps the memory traffic to that 1 KB
// and out of the way of the arithmetic:
//
//   * a block of 64 frames stages its rows of Xx and Xy in shared memory
//     with coalesced loads, and writes x0, y0, z0 back from there with
//     coalesced stores (a thread's row is 200 B, so direct accesses would
//     touch a sector per thread each);
//   * rows sit 51 words apart in shared memory, so the 32 threads of a warp,
//     each at its own row, hit 32 banks;
//   * the walk writes P[b] over the target it has just read (Xx[b], Xy[b]
//     are read by bone b - 1 alone), so P needs no room of its own, and a
//     bone whose start joint is not the last one placed reads P there;
//   * Y, the anchors, of the few joints that later bones start from again
//     (the shoulders, the elbows, the wrists: 5 of this tree) go to a
//     shared-memory stash of at most 8 slots, assigned by the entry point;
//     a bone that starts where the previous one ended (the arms and the
//     fingers are chains) keeps Y and P in registers.  (Every joint's Y and
//     P in a per-thread array, 1,200 B of local memory a thread, with the
//     rows accessed directly, ran 3.4x slower at B = 128, T = 1,920 on an
//     H100: 2.39 against 0.70 ms.)
//
// The tree's start joints come from ops/skeleton.py through the entry
// point's argument.

#include <cuda_runtime.h>

namespace {

constexpr int kJoints = 50;
constexpr int kBones = kJoints - 1;
constexpr int kRows = 64;             // frames a block, one a thread
constexpr int kStride = kJoints + 1;  // a row's words in shared memory
constexpr int kSlots = 8;             // stashed anchors

struct Tree {
  int start[kBones];           // bone i runs from joint start[i] to i + 1
  signed char read[kBones];    // stash slot of start[i]'s Y; -1: registers
  signed char write[kBones];   // stash slot for joint i + 1's Y, or -1
  int root;                    // stash slot for the root's Y, or -1
};

// the plain version's scalars, as PyTorch casts a Python float to float32
__device__ __forceinline__ float eps() { return static_cast<float>(1e-10); }
__device__ __forceinline__ float z_floor() { return static_cast<float>(0.001); }

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float sq(float a) { return __fmul_rn(a, a); }

__device__ __forceinline__ bool finite(float a) { return isfinite(a); }

// sqrt(hx^2 + hy^2 + hz^2) + 1e-10, summed left to right
__device__ __forceinline__ float norm3(float hx, float hy, float hz) {
  return add(__fsqrt_rn(add(add(sq(hx), sq(hy)), sq(hz))), eps());
}

// compute_b's reproj_err: the squared 2D distance from the target of the
// start joint moved by L along h
__device__ __forceinline__ float reproj_err(float hx, float hy, float hz,
                                            float ax, float ay, float tx,
                                            float ty, float L) {
  const float n = norm3(hx, hy, hz);
  const float xi_x = add(ax, dvd(mul(L, hx), n));
  const float xi_y = add(ay, dvd(mul(L, hy), n));
  return add(sq(sub(xi_x, tx)), sq(sub(xi_y, ty)));
}

// lifting/init3d.compute_b, one frame: the winning (bx, by, bz)
__device__ __forceinline__ void compute_b(float ax, float ay, float tx,
                                          float ty, float L, float& bx,
                                          float& by, float& bz) {
  const float dx = sub(tx, ax);
  const float dy = sub(ty, ay);
  // h0: in-plane direction
  const float foo = sub(sub(sq(L), sq(dx)), sq(dy));
  const float s = __fsqrt_rn(isnan(foo) ? foo : fmaxf(foo, 0.0f));  // clamp(min=0)
  const float foo1 =
      add(add(sub(add(sub(sq(ax), mul(mul(2.0f, ax), tx)), sq(ay)),
                  mul(mul(2.0f, ay), ty)),
              sq(tx)),
          sq(ty));
  const float foo2 = __fsqrt_rn(dvd(1.0f, foo1));  // (1.0 / foo1) ** 0.5
  const float common =
      sub(sub(add(add(add(dvd(mul(sq(ay), ay), foo1),
                          dvd(mul(sq(ax), ay), foo1)),
                      dvd(mul(ay, sq(tx)), foo1)),
                  dvd(mul(ay, sq(ty)), foo1)),
              dvd(mul(mul(2.0f, sq(ay)), ty), foo1)),
          dvd(mul(mul(mul(2.0f, ax), ay), tx), foo1));
  const float lay = mul(mul(L, ay), foo2);
  const float lty = mul(mul(L, ty), foo2);
  const float foo3 = sub(add(common, lay), lty);
  const float foo4 = add(sub(common, lay), lty);
  const float den = sub(ay, ty);
  const float base = sub(mul(ax, ty), mul(ay, tx));
  const float xx1 = dvd(-add(sub(base, mul(ax, foo3)), mul(tx, foo3)), den);
  const float xx2 = dvd(-add(sub(base, mul(ax, foo4)), mul(tx, foo4)), den);
  const bool valid12 = foo >= 0.0f;
  const bool valid34 = finite(xx1) && finite(xx2) && finite(foo3) && finite(foo4);
  const float inf = __int_as_float(0x7f800000);

  const float l0 = reproj_err(dx, dy, 0.0f, ax, ay, tx, ty, L);
  float best = finite(l0) ? l0 : inf;
  bx = dx;
  by = dy;
  bz = 0.0f;
  // hypotheses 1..4 in order: (dx, dy, -s), (dx, dy, s),
  // (xx1 - ax, foo3 - ay, 0), (xx2 - ax, foo4 - ay, 0)
  float l = reproj_err(dx, dy, -s, ax, ay, tx, ty, L);
  l = valid12 && finite(l) ? l : inf;
  if (l < best) { best = l; bz = -s; }
  l = reproj_err(dx, dy, s, ax, ay, tx, ty, L);
  l = valid12 && finite(l) ? l : inf;
  if (l < best) { best = l; bz = s; }
  const float h3x = sub(xx1, ax), h3y = sub(foo3, ay);
  l = reproj_err(h3x, h3y, 0.0f, ax, ay, tx, ty, L);
  l = valid34 && finite(l) ? l : inf;
  if (l < best) { best = l; bx = h3x; by = h3y; bz = 0.0f; }
  const float h4x = sub(xx2, ax), h4y = sub(foo4, ay);
  l = reproj_err(h4x, h4y, 0.0f, ax, ay, tx, ty, L);
  l = valid34 && finite(l) ? l : inf;
  if (l < best) { bx = h4x; by = h4y; bz = 0.0f; }
  // a non-finite error of h0 keeps h0 whatever the later hypotheses give
  if (!finite(l0)) { bx = dx; by = dy; bz = 0.0f; }
}

__global__ void __launch_bounds__(kRows)
lift_init_kernel(const float* __restrict__ Xx, const float* __restrict__ Xy,
                 const float* __restrict__ lengths,
                 const float* __restrict__ rootsx,
                 const float* __restrict__ rootsy,
                 const float* __restrict__ rootsz, float* __restrict__ x0,
                 float* __restrict__ y0, float* __restrict__ z0, int B, int T,
                 Tree tree) {
  // a row's targets, then its P: sx, sy hold Xx, Xy until the walk writes
  // x0, y0 over them; sz holds z0
  __shared__ float sx[kRows * kStride], sy[kRows * kStride], sz[kRows * kStride];
  __shared__ float stash[kSlots][3][kRows];
  const long long row0 = (long long)blockIdx.x * kRows;
  const int rows = (int)min((long long)kRows, (long long)B * T - row0);
  const int n = rows * kJoints;
  const long long base = row0 * kJoints;
  for (int e = threadIdx.x; e < n; e += kRows) {
    const int r = e / kJoints, k = r * kStride + e - r * kJoints;
    sx[k] = __ldg(Xx + base + e);
    sy[k] = __ldg(Xy + base + e);
  }
  __syncthreads();

  const int t = threadIdx.x;
  if (t < rows) {
    const long long row = row0 + t;
    float* px = sx + t * kStride;
    float* py = sy + t * kStride;
    float* pz = sz + t * kStride;
    const float* L_row = lengths + (row / T) * kBones;
    float Yx = __ldg(rootsx + row), Yy = __ldg(rootsy + row), Yz = __ldg(rootsz + row);
    float Px = Yx, Py = Yy, Pz = Yz;
    px[0] = Px;
    py[0] = Py;
    pz[0] = Pz;
    if (tree.root >= 0) {
      stash[tree.root][0][t] = Yx;
      stash[tree.root][1][t] = Yy;
      stash[tree.root][2][t] = Yz;
    }
#pragma unroll 1
    for (int i = 0; i < kBones; ++i) {
      const int s_in = tree.read[i];
      if (s_in >= 0) {  // not the last joint placed: P from the row, Y stashed
        const int a = tree.start[i];
        Px = px[a]; Py = py[a]; Pz = pz[a];
        Yx = stash[s_in][0][t]; Yy = stash[s_in][1][t]; Yz = stash[s_in][2][t];
      }
      const int b = i + 1;
      const float L = __ldg(L_row + i);
      float gx, gy, gz;
      compute_b(Yx, Yy, px[b], py[b], L, gx, gy, gz);
      // nan/inf guards, |z| + 0.001, normalisation (init3d.walk_bones)
      gx = finite(gx) ? gx : 0.0f;
      gy = finite(gy) ? gy : 0.0f;
      gz = finite(gz) ? gz : 0.0f;
      if (gx == 0.0f && gy == 0.0f && gz == 0.0f) gx = gy = gz = 1.0f;
      gz = add(fabsf(gz), z_floor());
      const float nrm = norm3(gx, gy, gz);
      gx = dvd(gx, nrm);
      gy = dvd(gy, nrm);
      gz = dvd(gz, nrm);
      Yx = add(Yx, mul(L, gx));
      Yy = add(Yy, mul(L, gy));
      Yz = add(Yz, mul(L, gz));
      // forward kinematics (filtering.forward_kinematics)
      const float nA = norm3(gx, gy, gz);
      Px = add(Px, mul(L, dvd(gx, nA)));
      Py = add(Py, mul(L, dvd(gy, nA)));
      Pz = add(Pz, mul(L, dvd(gz, nA)));
      px[b] = Px;
      py[b] = Py;
      pz[b] = Pz;
      const int s_out = tree.write[i];
      if (s_out >= 0) {
        stash[s_out][0][t] = Yx;
        stash[s_out][1][t] = Yy;
        stash[s_out][2][t] = Yz;
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n; e += kRows) {
    const int r = e / kJoints, k = r * kStride + e - r * kJoints;
    x0[base + e] = sx[k];
    y0[base + e] = sy[k];
    z0[base + e] = sz[k];
  }
}

}  // namespace

// C entry point (bound with ctypes).  All tensors are contiguous float32 on
// one device: Xx, Xy (B, T, 50), the per-clip bone lengths (B, 49), the
// roots' x, y, z (B, T) in; x0, y0, z0 (B, T, 50) out.  bone_start: the 49
// start joints of ops/skeleton.py's tree, on the host; bone i ends at joint
// i + 1, so each start must lie in [0, i].  Returns the cudaError_t of the
// launch (0 on success, cudaErrorInvalidValue for a shape or tree the
// kernel does not take); the kernel runs on `stream` and is not
// synchronised.
extern "C" int mhpe_lift_init(const float* Xx, const float* Xy,
                              const float* lengths, const float* rootsx,
                              const float* rootsy, const float* rootsz,
                              float* x0, float* y0, float* z0, int B, int T,
                              const int* bone_start, void* stream) {
  if (B < 1 || T < 1) return (int)cudaErrorInvalidValue;
  // a stash slot for each joint that a bone starts from other than right
  // after placing it
  int slot[kJoints];
  for (int j = 0; j < kJoints; ++j) slot[j] = -1;
  int used = 0;
  Tree tree;
  for (int i = 0; i < kBones; ++i) {
    const int a = bone_start[i];
    if (a < 0 || a > i) return (int)cudaErrorInvalidValue;
    tree.start[i] = a;
    if (a != i && slot[a] < 0) {
      if (used == kSlots) return (int)cudaErrorInvalidValue;
      slot[a] = used++;
    }
  }
  for (int i = 0; i < kBones; ++i) {
    tree.read[i] = (signed char)(tree.start[i] == i ? -1 : slot[tree.start[i]]);
    tree.write[i] = (signed char)slot[i + 1];
  }
  tree.root = slot[0];
  const long long rows = (long long)B * T;
  const long long blocks = (rows + kRows - 1) / kRows;
  lift_init_kernel<<<(unsigned)blocks, kRows, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      Xx, Xy, lengths, rootsx, rootsy, rootsz, x0, y0, z0, B, T, tree);
  return (int)cudaGetLastError();
}
