// Lifting filter: n_cycles SGD steps of direct xyz smoothing, for Hopper.
//
// Replaces the TPU kernel multimodal_hand_pose_enhancement_for_sign_language_tpu/
// ops/pallas_kernels.py: filter_sgd -> _filter_sgd_scaled -> _filter_kernel.
// Same function as lifting/filtering.filter_xyz batched over clips: for every
// (clip b, joint j) row, independently, and every cycle
//
//     d[t] = s[t] - s[t+1]                             (pm[t] = 0 at t >= t_real-1)
//     s[t] = s[t] + (b[t] - lw[t] s[t] + d[t-1] pm[t-1] - d[t] pm[t])
//
// for s in {x, y, z}, with lw = 2 lr w mask / (t_real J), b = lw * target,
// pm = 2 lr mask[t] mask[t+1] / ((t_real - 1) J), pm[-1] = 0.  z has no data
// term (lw = 0, b = 0).  The coefficients are folded here from the raw inputs
// (x0, y0, z0, tarx, tary, w, mask), so each input is read once and each
// output written once.  The time edges are explicit zeros rather than the
// TPU kernel's wrap-around roll.
//
// What bounds it on an H100: FP32 instruction issue on the CUDA cores.  Per
// element and cycle the update is 16 flops at the least (a s + b - d pm +
// d' pm'), written as 14 FP32 instructions (x and y: two FADD and three
// FFMA each; z: two FADD, one FMUL and one FFMA), 115 for a lane's 8 steps
// with its two end steps (chip_smoke.py counts them in the built library's
// SASS); device-memory traffic is 36 B
// per element plus the mask, once, against 900 cycles of that.  So the
// whole state stays in registers for all cycles, and the design spends as
// little as it can on anything but those instructions:
//
//   * each lane holds K = 8 consecutive steps of x, y, z and their
//     coefficients lw, bx, by, pm (81-93 registers, no spills; K = 16 took
//     140-160 registers, fewer warps, and measured slower);
//   * a row of T <= 32 K = 256 steps lives in L lanes of ONE warp (L the
//     least power of two with L K >= T); a warp packs 32 / L rows.  The edge
//     exchange of a cycle is six segmented shuffles (width L): each lane's
//     first values down, its last values up.  No shared memory, no barrier;
//   * a longer row (up to 4320 steps) spans W <= 18 warps, one row a block.
//     Lanes 1..30 of a warp own 30 K steps; lanes 0 and 31 are halos that
//     hold the neighbour warps' edge lanes and run the same update.  A halo's outer
//     step goes wrong each cycle (its outer neighbour is in another warp),
//     one step further each cycle, so the halos are refreshed every K
//     cycles, before the error reaches the owned lanes: lanes 1 and 30 write
//     their 24 values to a double-buffered shared-memory slot, the row's
//     live warps meet at a named barrier (bar.sync 1, 32 * warps; never a
//     block-wide __syncthreads), and lanes 0 and 31 read their neighbours'.
//     The exchange costs one barrier per K cycles, and the halos 2 of 32
//     lanes;
//   * within a cycle the interior steps 1..K-2, which need no neighbour, run
//     between the shuffles and the two end steps that use them;
//   * dead steps are skipped a warp at a time.  A row's mask sum (t_real)
//     and live end (one past its last unmasked step) come from a segmented
//     warp reduction over the owned lanes, plus one exchange through shared
//     memory for a row that spans warps.  Masked steps get a = 1, b = 0,
//     pm = 0: exact fixed points of the loop.  A warp whose owned steps all
//     lie at or past the live end of every row it holds (the pow2 padding
//     rows of a batch, the dead tail of a long row) writes x0, y0, z0
//     through and runs no cycle; the live warps of a long row are a prefix,
//     and its barrier counts only them.  So a padding row comes out as x0,
//     where the plain version gives NaN (t_real = 0), and a masked tail as
//     x0, exactly;
//   * a row longer than 4320 steps (a whole grouped video) is cut into G
//     segments of S = 30 K (W - 2) owned steps, one block each, of the
//     layout above: warps 1..W-2 own the segment, warps 0 and W-1 hold the
//     H = 30 K = 240 steps on either side (their halo lanes 8 more).  A
//     launch runs at most H cycles: the steps a block holds beyond its
//     window go wrong one step a cycle from the outside in, so after H
//     cycles the owned steps are still exact.  The block writes its owned
//     steps to a state buffer and the host relaunches on that buffer
//     (ping-pong, ceil(n_cycles / H) launches).  A window starts at a
//     multiple of 30 K, so every step sits in the same lane and slot as in
//     the one-block layout and runs the same instructions.  t_real and the
//     live end are the whole row's: each block sums the row's mask.  Warps
//     before step 0 or past the live end are dead, and a segment wholly
//     past it writes its state through.
//
// The update is the gradient form above, as the plain PyTorch version
// writes it: the increment is summed first and s rounded once a cycle, so
// the two agree to rounding (2e-4 at 900 cycles is the stated tolerance).
// The folded form a s + b - d pm + d' pm' (a = 1 - lw; 11 instructions)
// rounds s after each term: a long row's terms (~1 / t_real) fall under half
// an ulp of s and are lost, 3.5e-4 from the plain version on an 8,700-step
// lifting row.  The 3-tap form s' = c s + pm[t] s[t+1] + pm[t-1] s[t-1] + b
// (9 instructions) was dropped for the same reason: 2.41e-4 at T = 4096.

#include <cuda_runtime.h>

namespace {

constexpr int kJoints = 50;
constexpr int K = 8;                // time steps a lane holds
constexpr int kOwned = 30;          // lanes a warp owns in a row of W > 1 warps
constexpr int kMaxWarps = 18;       // 576 threads: one block holds T <= 4320
constexpr int kMaxThreads = 32 * kMaxWarps;
constexpr unsigned kFull = 0xffffffffu;

// the barrier of a row of W warps (its block): named, so that only the
// row's live warps wait on it
__device__ __forceinline__ void row_barrier(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// What the two end steps of a lane need from its interior sweep: the old
// differences t[0] = s[0] - s[1] and t[K-2] = s[K-2] - s[K-1].
struct Edges {
  float first, last;
};

// The new value of one step from its increment, summed before it meets s:
//   s + (b - lw s + t[k-1] pm[k-1] - t[k] pm[k])      (DATA)
//   s + (t[k-1] pm[k-1] - t[k] pm[k])                  (z)
// The increment shrinks as 1 / t_real; added term by term to s (as
// a s + b - d + d' did), a long row's terms fall under half an ulp of s and
// round away, which put an 8,700-step lifting row 3.5e-4 from the plain
// version.  Here s is rounded once a cycle, as the plain version rounds it.
template <bool DATA>
__device__ __forceinline__ float step(float s, float lw, float b, float t_left,
                                      float pm_left, float t, float pm) {
  float acc = DATA ? fmaf(t_left, pm_left, fmaf(-lw, s, b)) : t_left * pm_left;
  return s + fmaf(-t, pm, acc);
}

// Steps 1..K-2 of one coordinate, in place, from the old state.  DATA is
// false for z (lw = 0, b = 0).
template <bool DATA>
__device__ __forceinline__ Edges interior(float (&s)[K], const float (&lw)[K],
                                          const float (&b)[K],
                                          const float (&pm)[K]) {
  float tl = s[0] - s[1];
  const float t0 = tl;
#pragma unroll
  for (int k = 1; k < K - 1; ++k) {
    const float t = s[k] - s[k + 1];
    s[k] = step<DATA>(s[k], lw[k], b[k], tl, pm[k - 1], t, pm[k]);
    tl = t;
  }
  return {t0, tl};
}

// Steps 0 and K-1 of one coordinate, once the neighbours' values are in:
// `left` is the old s[-1], `right` the old s[K].
template <bool DATA>
__device__ __forceinline__ void ends(float (&s)[K], const float (&lw)[K],
                                     const float (&b)[K], const float (&pm)[K],
                                     float pm_left, float left, float right,
                                     Edges e) {
  constexpr int n = K - 1;
  const float s0 = s[0];
  s[0] = step<DATA>(s0, lw[0], b[0], left - s0, pm_left, e.first, pm[0]);
  s[n] = step<DATA>(s[n], lw[n], b[n], e.last, pm[n - 1], s[n] - right, pm[n]);
}

// MULTI: a row spans W > 1 warps, one row a block; lanes 1..30 of a warp own
// its steps, lanes 0 and 31 are halos holding copies of the neighbour warps'
// edge lanes.  Otherwise a row is L lanes of one warp, all owned, and a
// block packs R rows.  SEG (with MULTI): the block is segment blockIdx % G
// of row blockIdx / G, its warps 0 and W-1 the segment's halo warps; the
// state comes from and goes to the host's ping-pong buffers.
template <bool MULTI, bool SEG>
__global__ void __launch_bounds__(kMaxThreads) filter_sgd_kernel(
    const float* __restrict__ x0, const float* __restrict__ y0,
    const float* __restrict__ z0, const float* __restrict__ tarx,
    const float* __restrict__ tary, const float* __restrict__ w,
    const float* __restrict__ mask, float* __restrict__ xo,
    float* __restrict__ yo, float* __restrict__ zo, int B, int T, int L,
    int W, int R, int G, float lr, int n_cycles) {
  // halo[parity][warp][side][coordinate][step]: side 0 is the warp's lane 1
  // (its first owned steps), side 1 its lane 30 (its last)
  __shared__ float halo[2][kMaxWarps][2][3][K];
  __shared__ float part_sum[kMaxWarps];
  __shared__ int part_end[kMaxWarps];

  if (MULTI) L = 32;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;  // the warp within the row when MULTI
  const int r = SEG ? 0 : tid / (L * W);
  const long long row =
      SEG ? (long long)(blockIdx.x / G) : (long long)blockIdx.x * R + r;
  const bool row_ok = row < (long long)B * kJoints;
  const int b = row_ok ? (int)(row / kJoints) : 0;
  const int j = (int)(row % kJoints);
  const bool owned = !MULTI || (lane >= 1 && lane <= kOwned);
  // the window's first step: a segment's owned steps start one halo warp
  // (kOwned K steps) after it
  const int win0 =
      SEG ? ((int)(blockIdx.x % G) * (W - 2) - 1) * kOwned * K : 0;
  const int t0 =
      MULTI ? win0 + (warp * kOwned + lane - 1) * K : (tid - r * L) * K;
  const float* m = mask + (long long)b * T;

  float mk[K + 1];
#pragma unroll
  for (int k = 0; k <= K; ++k) {
    const int t = t0 + k;
    mk[k] = (row_ok && t >= 0 && t < T) ? m[t] : 0.f;
  }
  const float m_left =
      (row_ok && t0 > 0 && t0 - 1 < T) ? m[t0 - 1] : 0.f;

  // the row's mask sum and live end, over the owned steps (a segment: over
  // the whole row, strided over the block): 0/1 partial sums are exact in
  // f32, so the reduction order cannot change them
  float t_real = 0.f;
  int t_end = 0;
  if (SEG) {
    for (int t = tid; t < T; t += 32 * W) {
      const float v = m[t];
      t_real += v;
      if (v != 0.f) t_end = t + 1;
    }
  } else if (owned) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      t_real += mk[k];
      if (mk[k] != 0.f) t_end = t0 + k + 1;
    }
  }
  for (int off = 1; off < L; off <<= 1) {
    t_real += __shfl_xor_sync(kFull, t_real, off, L);
    t_end = max(t_end, __shfl_xor_sync(kFull, t_end, off, L));
  }
  if (MULTI) {
    if (lane == 0) {
      part_sum[warp] = t_real;
      part_end[warp] = t_end;
    }
    row_barrier(32 * W);
    t_real = 0.f;
    t_end = 0;
    for (int v = 0; v < W; ++v) {
      t_real += part_sum[v];
      t_end = max(t_end, part_end[v]);
    }
  }
  const float c_data = 2.f * lr / (t_real * (float)kJoints);
  const float c_pair = 2.f * lr / ((t_real - 1.f) * (float)kJoints);

  float sx[K], sy[K], sz[K], lw[K], bx[K], by[K], pm[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int t = t0 + k;
    const float mt = mk[k];
    sx[k] = sy[k] = sz[k] = 0.f;
    lw[k] = bx[k] = by[k] = pm[k] = 0.f;
    if (row_ok && t >= 0 && t < T) {
      const long long idx = ((long long)b * T + t) * kJoints + j;
      sx[k] = x0[idx];
      sy[k] = y0[idx];
      sz[k] = z0[idx];
      if (mt != 0.f) {
        lw[k] = c_data * w[idx] * mt;
        bx[k] = lw[k] * tarx[idx];
        by[k] = lw[k] * tary[idx];
        if (mk[k + 1] != 0.f) pm[k] = mt * mk[k + 1] * c_pair;
      }
    }
  }
  // pair (t0-1, t0) belongs to the left neighbour; its sd enters s[t0]
  const float pm_left =
      (m_left != 0.f && mk[0] != 0.f) ? m_left * mk[0] * c_pair : 0.f;

  // live warps: a one-warp row starts at step 0, so its warp is live if
  // any row in it has a live step; a row of W warps keeps the warps
  // [lo, hi) whose owned steps reach past step 0 (all but a first
  // segment's left halo warp) and start before its live end, and a
  // segment none of them if its own warps (1..W-2) are all dead
  int lo = 0, hi = 1;
  bool live;
  if (MULTI) {
    constexpr int span = kOwned * K;
    lo = (SEG && win0 < 0) ? 1 : 0;
    hi = t_end > win0 ? min(W, (t_end - win0 + span - 1) / span) : 0;
    if (SEG && hi < 2) hi = 0;
    live = warp >= lo && warp < hi;
  } else {
    live = __any_sync(kFull, t_end > 0);
  }

  if (live) {
    for (int c = 0; c < n_cycles; ++c) {
      if (MULTI && c > 0 && c % K == 0) {
        // refresh the halos: a halo lane's outermost step goes wrong one
        // step a cycle (its outer neighbour is not in the warp), so after
        // K cycles the wrong values reach, but have not yet been read by,
        // the owned lane beside it.  The parity flip keeps the next refresh
        // from overwriting what a slow warp still reads; a dead warp never
        // changes (all its steps are fixed points), so its neighbour keeps
        // the halo it has.
        const int par = (c / K) & 1;
        if (lane == 1 || lane == kOwned) {
          float* dst = &halo[par][warp][lane == 1 ? 0 : 1][0][0];
#pragma unroll
          for (int k = 0; k < K; ++k) {
            dst[k] = sx[k];
            dst[K + k] = sy[k];
            dst[2 * K + k] = sz[k];
          }
        }
        row_barrier(32 * (hi - lo));
        const bool from_left = lane == 0 && warp > lo;
        const bool from_right = lane == 31 && warp + 1 < hi;
        if (from_left || from_right) {
          const float* src = from_left ? &halo[par][warp - 1][1][0][0]
                                       : &halo[par][warp + 1][0][0][0];
#pragma unroll
          for (int k = 0; k < K; ++k) {
            sx[k] = src[k];
            sy[k] = src[K + k];
            sz[k] = src[2 * K + k];
          }
        }
      }
      // the right neighbour's first step and the left neighbour's last (at
      // a segment edge a lane gets its own value back; pm is 0 there, or
      // the lane is a halo)
      const float rx = __shfl_down_sync(kFull, sx[0], 1, L);
      const float ry = __shfl_down_sync(kFull, sy[0], 1, L);
      const float rz = __shfl_down_sync(kFull, sz[0], 1, L);
      const float lx = __shfl_up_sync(kFull, sx[K - 1], 1, L);
      const float ly = __shfl_up_sync(kFull, sy[K - 1], 1, L);
      const float lz = __shfl_up_sync(kFull, sz[K - 1], 1, L);
      // steps 1..K-2 need no neighbour: they hide the shuffles' latency
      const Edges ex = interior<true>(sx, lw, bx, pm);
      const Edges ey = interior<true>(sy, lw, by, pm);
      const Edges ez = interior<false>(sz, lw, bx, pm);
      ends<true>(sx, lw, bx, pm, pm_left, lx, rx, ex);
      ends<true>(sy, lw, by, pm, pm_left, ly, ry, ey);
      ends<false>(sz, lw, bx, pm, pm_left, lz, rz, ez);
    }
  }

  if (!row_ok || !owned || (SEG && (warp == 0 || warp == W - 1))) return;
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

}  // namespace

// C entry point (bound with ctypes).  All tensors are contiguous float32 on
// one device: six (B, T, 50) planes and a (B, T) mask in, three (B, T, 50)
// planes out; the first three inputs are the state the cycles start from
// (x0, y0, z0, or a long row's ping-pong buffer).  (k, l, wr, r, g) is the
// host's launch_plan: steps per lane (8), lanes per row in a warp, warps per
// row (a block), rows per block, and segments per row (g > 1: a long row,
// at most 30 K = 240 cycles a launch).  Returns the cudaError_t of the
// launch (0 on success, cudaErrorInvalidValue for a plan the kernel does
// not take); the kernel runs on `stream` and is not synchronised.
extern "C" int mhpe_filter_sgd(const float* x0, const float* y0,
                               const float* z0, const float* tarx,
                               const float* tary, const float* w,
                               const float* mask, float* xo, float* yo,
                               float* zo, int B, int T, float lr, int n_cycles,
                               int k, int l, int wr, int r, int g,
                               void* stream) {
  const int threads = r * l * wr;
  const bool pow2 = l >= 1 && l <= 32 && (l & (l - 1)) == 0;
  const bool one_warp =
      g == 1 && wr == 1 && pow2 && l * K >= T && threads % 32 == 0;
  const bool multi = g == 1 && wr > 1 && wr <= kMaxWarps && l == 32 &&
                     r == 1 && kOwned * K * wr >= T;
  const bool seg = g > 1 && wr > 2 && wr <= kMaxWarps && l == 32 && r == 1 &&
                   (long long)kOwned * K * (wr - 2) * g >= T &&
                   n_cycles <= kOwned * K;
  if (k != K || r < 1 || T < 1 || n_cycles < 0 || threads > kMaxThreads ||
      !(one_warp || multi || seg))
    return (int)cudaErrorInvalidValue;
  const long long blocks = seg ? (long long)B * kJoints * g
                               : ((long long)B * kJoints + r - 1) / r;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (seg)
    filter_sgd_kernel<true, true><<<(unsigned)blocks, threads, 0, s>>>(
        x0, y0, z0, tarx, tary, w, mask, xo, yo, zo, B, T, l, wr, r, g, lr,
        n_cycles);
  else if (multi)
    filter_sgd_kernel<true, false><<<(unsigned)blocks, threads, 0, s>>>(
        x0, y0, z0, tarx, tary, w, mask, xo, yo, zo, B, T, l, wr, r, g, lr,
        n_cycles);
  else
    filter_sgd_kernel<false, false><<<(unsigned)blocks, threads, 0, s>>>(
        x0, y0, z0, tarx, tary, w, mask, xo, yo, zo, B, T, l, wr, r, g, lr,
        n_cycles);
  return (int)cudaGetLastError();
}
