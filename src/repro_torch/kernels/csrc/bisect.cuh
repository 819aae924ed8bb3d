// Shared device code of the EF client kernels and the standalone Block-TopK:
// the threshold bisection of src/repro/kernels/topk_compress.py::
// _bisect_threshold, run by a group of G lanes on one row held in registers
// (G = 32, a whole warp, for the rows of K2/K3 and rows of K1 wider than 32,
// up to 1024; wider rows run the same loop across a CTA, wide.cuh).
//
// Layouts: `bisect_threshold` takes a row of `width` <= G*PER values spread
// over the G lanes of its group, lane l holding elements l, l+G, l+2G, ...
// (K1, K2 and K3's narrow rows; every group-wide load and store touches
// consecutive addresses); elements at or past `width` are absent: never
// counted, never stored. `bisect_threshold_by` takes any layout, with a
// predicate that says which registers hold present elements: the staged
// kernel of K2 and K3 (staged.cuh) gives each lane runs of 4 or 8
// consecutive values and tests presence a run at a time, or not at all on
// a full row.
//
// Arithmetic: at most kBisectIters f32 steps of mid = 0.5*(lo+hi) on
// [0, max|x|], each counting |x| >= mid over the row with a group
// reduction; the reference's result is the largest lo with
// count(|x| >= lo) >= k after exactly 26 steps, and the callers keep the
// set {|x| >= lo}. Every rounding is spelled out (__fadd_rn/__fmul_rn) so
// nvcc cannot contract or reorder it: the plain PyTorch version
// (kernels/ref.py::bisect_threshold_plain) makes the same roundings, and
// the kept sets agree bit for bit (an integer count and a max do not depend
// on the order of the reduction). The max propagates NaN, as the
// reference's jnp.max does: a row holding a NaN gets hi = NaN, no mid ever
// keeps k values, and lo stays 0 (every value but the NaN kept), in the
// kernels as in the reference.
//
// Early exit. Every later lo is a mid with count(|x| >= mid) >= k, so it
// lies in [lo, x_k], x_k the row's k-th largest |x|, and only values in
// [lo, x_k) can still leave the set. The loop stops once that range holds
// no present value, on one of two tests, both taken on counts the loop
// already has (lo's count before lo first moves taken as the row's present
// count, which can only overestimate it: a NaN is never counted):
//   - count(|x| >= lo) == k: the set has exactly k values, those at or
//     above x_k, and every later set has at least k of them;
//   - count(|x| >= lo) == count(|x| >= hi): no value lies in [lo, hi) at
//     all (hi's count is unknown until hi first moves). Alone this rule
//     never fires on a row with k or more present values, whose x_k always
//     lies in [lo, hi); it ends rows with fewer than k.
// The returned lo then keeps exactly the set the 26-step threshold keeps
// (the threshold itself is never stored, only the set it selects). Rows
// with ties across the k-th value (count(|x| >= x_k) > k), all-zero rows
// and rows with fewer than k nonzero values take all 26 steps. The test is
// made across the whole warp (__all_sync), so groups of fewer than 32
// lanes keep shuffling until every group of the warp is done; a finished
// group's further steps keep its set. On Gaussian rows at k 16 of 1024 the
// loop stops after about 8 to 10 steps; tests/test_torch_kernels.py holds
// an emulation of it against the 26-step set on adversarial rows.
//
// The EF state (v, g) is f32 or bfloat16: it is loaded into f32, all
// arithmetic is f32, and bf16 results are stored rounded to nearest even
// (what XLA's astype does).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace efk {

constexpr int kBisectIters = 26;  // BISECT_ITERS of the reference
constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 4;  // one warp per row, four rows per CTA
// the widest row of the warp routes; wider rows take wide.cuh's CTA a row
constexpr int kMaxWidth = 32 * kWarp;

// f32 views of the element types: exact widenings
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// an f32 result in the state's type, rounded to nearest even
template <typename S>
__device__ __forceinline__ S from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// max(a, b), NaN when either is NaN (fmaxf drops a NaN operand)
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Reductions inside a group of G lanes (G a power of two, at most a warp).
// Every lane of the warp takes part: xor offsets below G stay in the group.
template <int G>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    x = max_nan(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int G>
__device__ __forceinline__ int group_sum(int x) {
  if constexpr (G == kWarp) {
    return __reduce_add_sync(0xffffffffu, x);
  } else {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
      x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
  }
}

__device__ __forceinline__ float warp_max(float x) {
  return group_max<kWarp>(x);
}

// max over the present elements of |d| (0 for an all-zero row, NaN for a
// row holding a NaN)
template <int PER, int G = kWarp>
__device__ __forceinline__ float row_absmax(const float (&d)[PER], int lane,
                                            int width) {
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i)
    if (i * G + lane < width) m = max_nan(m, fabsf(d[i]));
  return group_max<G>(m);
}

// A threshold that keeps the row's 26-step set: count(|d| >= t) >= k, the
// set {|d| >= t} that of the reference's 26-step t (see the early exit
// above). hi is the row's max |d| over present elements (NaN-propagating),
// n_present their count, present(i) whether register i holds a present
// element.
template <int PER, int G, typename Present>
__device__ __forceinline__ float bisect_threshold_by(const float (&d)[PER],
                                                     float hi, int n_present,
                                                     int k, Present present) {
  float lo = 0.f;
  int cnt_lo = n_present, cnt_hi = -1;          // -1: not counted yet
#pragma unroll 1
  for (int it = 0; it < kBisectIters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    int cnt = 0;
#pragma unroll
    for (int i = 0; i < PER; ++i)
      cnt += (present(i) && fabsf(d[i]) >= mid) ? 1 : 0;
    cnt = group_sum<G>(cnt);
    if (cnt >= k) {
      lo = mid;
      cnt_lo = cnt;
    } else {
      hi = mid;
      cnt_hi = cnt;
    }
    if (__all_sync(0xffffffffu, cnt_lo == k || cnt_lo == cnt_hi)) break;
  }
  return lo;
}

// The same on the strided layout of a group of G lanes.
template <int PER, int G = kWarp>
__device__ __forceinline__ float bisect_threshold(const float (&d)[PER],
                                                  int lane, int width, int k) {
  return bisect_threshold_by<PER, G>(
      d, row_absmax<PER, G>(d, lane, width), width, k,
      [&](int i) { return i * G + lane < width; });
}

// v' = (1-eta)*v + eta*grad and delta = v' - g for one row, with v' stored
// (in the state's type S) as soon as it is known; delta is taken from the
// f32 v' before that rounding, as the Pallas body computes it. Each element
// is loaded before anything is stored to it, by the one lane that owns it,
// so outputs may alias inputs element for element (the caller updates the
// EF state in place).
template <int PER, typename S>
__device__ __forceinline__ void momentum_delta(
    const float* grad, const S* v, const S* g, S* v_out, long long base,
    int lane, int width, float c1, float c2, float (&d)[PER],
    float (&gv)[PER]) {
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int j = i * kWarp + lane;
    d[i] = 0.f;
    gv[i] = 0.f;
    if (j < width) {
      const float gj = to_f32(g[base + j]);
      const float vn = __fadd_rn(__fmul_rn(c1, to_f32(v[base + j])),
                                 __fmul_rn(c2, grad[base + j]));
      v_out[base + j] = from_f32<S>(vn);
      gv[i] = gj;
      d[i] = __fsub_rn(vn, gj);
    }
  }
}

// rows per launch geometry shared by the host launchers
inline unsigned grid_for_rows(long long rows) {
  return static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
}

}  // namespace efk
