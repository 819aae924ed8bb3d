// Shared device code of the EF client kernels: the Block-TopK threshold
// bisection of src/repro/kernels/topk_compress.py::_bisect_threshold, run by
// one warp on one row held in registers.
//
// Layout: a row of `width` <= 32*PER f32 values is spread over the 32 lanes
// of a warp, lane l holding elements l, l+32, l+64, ... (so every warp-wide
// load and store touches consecutive addresses). Elements at or past `width`
// are absent: they are never counted and never stored.
//
// Arithmetic: exactly kBisectIters f32 steps of mid = 0.5*(lo+hi) on
// [0, max|x|], each counting |x| >= mid over the row with a warp reduction;
// the result is the largest lo with count(|x| >= lo) >= k. Every rounding is
// spelled out (__fadd_rn/__fmul_rn) so nvcc cannot contract or reorder it:
// the plain PyTorch version (kernels/ref.py::bisect_threshold_plain) makes
// the same roundings, and the two agree bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace efk {

constexpr int kBisectIters = 26;  // BISECT_ITERS of the reference
constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 4;  // one warp per row, four rows per CTA
constexpr int kMaxWidth = 32 * kWarp;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// max over the present elements of |d| (0 for an all-zero row)
template <int PER>
__device__ __forceinline__ float row_absmax(const float (&d)[PER], int lane,
                                            int width) {
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i)
    if (i * kWarp + lane < width) m = fmaxf(m, fabsf(d[i]));
  return warp_max(m);
}

// The threshold t of the row: count(|d| >= t) >= k, t maximal up to the
// 26-step resolution. Ties at t are all kept by the caller's |d| >= t test.
template <int PER>
__device__ __forceinline__ float bisect_threshold(const float (&d)[PER],
                                                  int lane, int width, int k) {
  float hi = row_absmax<PER>(d, lane, width);
  float lo = 0.f;
#pragma unroll 1
  for (int it = 0; it < kBisectIters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    int cnt = 0;
#pragma unroll
    for (int i = 0; i < PER; ++i)
      cnt += (i * kWarp + lane < width && fabsf(d[i]) >= mid) ? 1 : 0;
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    const bool ok = cnt >= k;
    lo = ok ? mid : lo;
    hi = ok ? hi : mid;
  }
  return lo;
}

// v' = (1-eta)*v + eta*grad and delta = v' - g for one row, with v' stored
// as soon as it is known. Each element is loaded before anything is stored
// to it, by the one lane that owns it, so outputs may alias inputs element
// for element (the caller updates the EF state in place).
template <int PER>
__device__ __forceinline__ void momentum_delta(
    const float* grad, const float* v, const float* g, float* v_out,
    long long base, int lane, int width, float c1, float c2, float (&d)[PER],
    float (&gv)[PER]) {
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int j = i * kWarp + lane;
    d[i] = 0.f;
    gv[i] = 0.f;
    if (j < width) {
      const float gj = g[base + j];
      const float vn = __fadd_rn(__fmul_rn(c1, v[base + j]),
                                 __fmul_rn(c2, grad[base + j]));
      v_out[base + j] = vn;
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
