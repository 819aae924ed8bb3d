// The wide-row route of the threshold bisection, for rows wider than the
// warp routes hold (kMaxWidth, 1024 values): K1 (topk.cu), K2
// (ef_update.cu) and K3 (fused_round.cu) take it for any wider Block-TopK
// block, as the reference's Pallas kernels take a block of any width.
//
// Design: one CTA of kWideThreads a row; thread t owns elements t, t+T,
// t+2T, ... (consecutive threads on consecutive addresses for every load
// and store). Each bisection step counts |d| >= mid over the thread's
// elements, sums the counts across the warp by shuffle and across the
// CTA's warps in shared memory (one barrier a step; CtaReduce), so every
// thread holds the row's count and the early exit of bisect.cuh (exactly k
// values at or above lo, or none in [lo, hi)) is decided alike by every
// thread of the CTA: every warp runs the same number of barriered steps.
// The max over the row uses max_nan, so a NaN propagates as the
// reference's jnp.max does. Counts and maxima do not depend on the order
// of a reduction, so the kept set equals the plain version's bit for bit,
// as on the warp routes (bisect.cuh).
//
// Where the row lives between the steps:
//   - staged (the row fits one CTA's shared memory, kWideSmemBytes): the
//     first pass reads the row once from device memory and keeps it in
//     shared memory, as f32: K1 its x (4 bytes a value), K2/K3 the delta
//     d = v' - g taken from the f32 v' BEFORE v' is rounded to the state's
//     type, and g (8 bytes a value). K2/K3 store v' in that first pass
//     (each element read by its owner before the owner stores it); the
//     steps and the epilogue read shared memory only;
//   - global (wider rows, more than 28,672 values for K2/K3 and 57,344 for
//     K1): nothing is kept. Every pass recomputes x or d from the inputs in
//     device memory (the row's few MB stay in L2 between passes), and K2/K3
//     store nothing, not even v', before the last pass: the inputs stay
//     unchanged until then, so every recomputed d has the bits of the
//     first (d comes from the f32 v' of the unchanged v, never from a
//     stored, rounded v'). In the last pass each element is read and then
//     written by one thread alone, after a barrier that every earlier read
//     precedes, so the outputs may alias the inputs (the in-place EF state
//     update) on this route too.
// The route is picked by width alone (wide_layout), never by the data.
#pragma once

#include "staged.cuh"

namespace efk {

constexpr int kWideThreads = 256;
constexpr int kWideWarps = kWideThreads / kWarp;
// dynamic shared memory a wide CTA keeps its row in (the card's 227 KB a
// block, less room for the static reduction slots)
constexpr int kWideSmemBytes = 224 * 1024;
// bytes a staged value takes: K1 keeps x, K2/K3 d and g, each as f32
constexpr int kTopkWideBytes = 4;
constexpr int kEfWideBytes = 8;

// 0: not a wide row (the warp routes); 1: a wide row staged in shared
// memory; 2: a wide row recomputed from device memory each pass
inline int wide_layout(long long width, int bytes_per_value) {
  if (width <= kMaxWidth) return 0;
  return width * bytes_per_value <= kWideSmemBytes ? 1 : 2;
}

// CTA-wide sum and max, one barrier a call. The warps' partials go to
// slots double-buffered by a parity that every thread flips alike, so a
// call may follow another at once: a thread that writes call n+1's slots
// has passed call n's barrier, before which every thread read call n-1's.
struct CtaReduce {
  int (*si)[kWideWarps];
  float (*sf)[kWideWarps];
  int parity;

  __device__ __forceinline__ int sum(int x) {
    x = group_sum<kWarp>(x);
    const int w = threadIdx.x / kWarp;
    if (threadIdx.x % kWarp == 0) si[parity][w] = x;
    __syncthreads();
    int s = 0;
#pragma unroll
    for (int i = 0; i < kWideWarps; ++i) s += si[parity][i];
    parity ^= 1;
    return s;
  }

  __device__ __forceinline__ float max(float x) {
    x = group_max<kWarp>(x);
    const int w = threadIdx.x / kWarp;
    if (threadIdx.x % kWarp == 0) sf[parity][w] = x;
    __syncthreads();
    float m = sf[parity][0];
#pragma unroll
    for (int i = 1; i < kWideWarps; ++i) m = max_nan(m, sf[parity][i]);
    parity ^= 1;
    return m;
  }
};

// The shared slots of one CTA's reductions.
#define EFK_WIDE_REDUCE(name)                                                \
  __shared__ int name##_si[2][kWideWarps];                                   \
  __shared__ float name##_sf[2][kWideWarps];                                 \
  CtaReduce name{name##_si, name##_sf, 0}

// bisect_threshold_by's loop on a whole CTA: count(mid) returns the
// calling thread's count of |d| >= mid over its elements; hi is the row's
// max |d| (NaN-propagating), n_present its present values. Every thread
// returns the same threshold.
template <typename Count>
__device__ __forceinline__ float wide_bisect(float hi, int n_present, int k,
                                             CtaReduce& red, Count count) {
  float lo = 0.f;
  int cnt_lo = n_present, cnt_hi = -1;          // -1: not counted yet
#pragma unroll 1
  for (int it = 0; it < kBisectIters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    const int cnt = red.sum(count(mid));
    if (cnt >= k) {
      lo = mid;
      cnt_lo = cnt;
    } else {
      hi = mid;
      cnt_hi = cnt;
    }
    // the counts are the CTA's: every thread takes the same branch
    if (cnt_lo == k || cnt_lo == cnt_hi) break;
  }
  return lo;
}

// One wide row of K2/K3: the inputs, and where d and g are read from.
template <bool STAGED, typename S>
struct WideRow {
  StagedRows<S> in;
  long long base;
  float* s_d;              // d of the row (STAGED)
  float* s_g;              // g of the row, f32 (STAGED)

  // v' and d = v' - g of element j from the inputs, g widened to f32
  __device__ __forceinline__ void compute(int j, float& vn, float& gj,
                                          float& dj) const {
    gj = to_f32(in.g[base + j]);
    vn = __fadd_rn(__fmul_rn(in.c1, to_f32(in.v[base + j])),
                   __fmul_rn(in.c2, in.grad[base + j]));
    dj = __fsub_rn(vn, gj);
  }

  // d of element j in a counting pass (nothing is stored)
  __device__ __forceinline__ float delta(int j) const {
    if constexpr (STAGED) {
      return s_d[j];
    } else {
      float vn, gj, dj;
      compute(j, vn, gj, dj);
      return dj;
    }
  }

  // d and g of element j in the last pass; the route that kept nothing
  // stores v' here, after its last read of the element
  __device__ __forceinline__ void last(int j, float& dj, float& gj) const {
    if constexpr (STAGED) {
      dj = s_d[j];
      gj = s_g[j];
    } else {
      float vn;
      compute(j, vn, gj, dj);
      in.v_out[base + j] = from_f32<S>(vn);
    }
  }
};

// The wide walk of K2 and K3: one CTA a row. `epi(row, base, t, row_ref,
// red)` finishes a row with the threshold t: it reads each element's d and
// g once through row_ref.last (in the last pass), may read d more through
// row_ref.delta before that, and stores the kernel's outputs.
template <bool STAGED, typename S, typename Epilogue>
__global__ void __launch_bounds__(kWideThreads)
wide_rows_kernel(const StagedRows<S> in, const Epilogue epi) {
  extern __shared__ __align__(16) float wide_smem[];
  EFK_WIDE_REDUCE(red);
  const int width = in.width;
  const long long row = blockIdx.x;
  const long long base = row * width;
  const WideRow<STAGED, S> r{in, base, wide_smem, wide_smem + width};

  // the first pass: the row's max |d|; staged, v' stored and d, g kept
  float m = 0.f;
#pragma unroll 4
  for (int j = threadIdx.x; j < width; j += kWideThreads) {
    float vn, gj, dj;
    r.compute(j, vn, gj, dj);
    if constexpr (STAGED) {
      in.v_out[base + j] = from_f32<S>(vn);
      r.s_d[j] = dj;
      r.s_g[j] = gj;
    }
    m = max_nan(m, fabsf(dj));
  }
  const float hi = red.max(m);                  // the row staged, too
  const float t = wide_bisect(hi, width, in.k, red, [&](float mid) {
    int c = 0;
#pragma unroll 4
    for (int j = threadIdx.x; j < width; j += kWideThreads)
      c += fabsf(r.delta(j)) >= mid ? 1 : 0;
    return c;
  });
  epi(row, base, t, r, red);
}

// One launch: a CTA a row, the row kept in shared memory where it fits.
// A failure is left for the caller's cudaGetLastError.
template <typename S, typename Epilogue>
static void launch_wide(const StagedRows<S>& in, const Epilogue& epi,
                        cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>(in.rows);
  if (wide_layout(in.width, kEfWideBytes) == 1) {
    auto kernel = wide_rows_kernel<true, S, Epilogue>;
    const int smem = in.width * kEfWideBytes;
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess)
      return;
    kernel<<<grid, kWideThreads, smem, s>>>(in, epi);
  } else {
    wide_rows_kernel<false, S, Epilogue><<<grid, kWideThreads, 0, s>>>(in,
                                                                      epi);
  }
}

}  // namespace efk
