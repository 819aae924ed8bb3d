// Standalone Block-TopK for Hopper (sm_90a).
//
// Replaces src/repro/kernels/topk_compress.py::block_topk (the Pallas TPU
// kernel _topk_kernel): x of any shape and float dtype is taken flat as d
// values, zero-padded to rows of `block`; per row, exactly 26 f32 bisection
// steps (bisect.cuh) find the largest t with count(|x| >= t) >= k, and the
// output keeps x where |x| >= t and is 0 elsewhere (ties at t are all
// kept). The output has x's dtype; only its first d values are written.
//
// Bound: memory. Each value is read once and written once (8 bytes an f32
// value); the 26 counting passes run on registers.
//
// Design: a group of G lanes a row with the row in registers, lane l holding
// elements l, l+G, ...; rows wider than 32 take a whole warp (G = 32, up to
// 32 values a lane, so rows up to 1024 wide), narrower rows a group of G
// lanes, G the width rounded up to a power of two, 256/G rows a CTA (the
// lane groups of the K5/K6 codec kernels). The count of a bisection step is
// a shuffle reduction inside the group, with no barrier. The zero padding of
// the last row is never materialised: a value past d is read as 0 and takes
// part in the counts, as the reference's padded zeros do, and is not
// stored.
//
// Rows wider than 1024 (any wider block) take the wide route of wide.cuh:
// one CTA of 256 threads a row, the row's x kept in shared memory as f32
// (rows up to 57,344 values) or read again from device memory each pass
// (wider rows), the counts summed across the CTA, the early exit decided
// for the whole CTA. The ragged last row reads as zeros past d, as above.
#include "wide.cuh"

namespace efk {

constexpr int kTopkThreads = 256;

template <int PER, int G, typename T>
__global__ void __launch_bounds__(kTopkThreads)
block_topk_kernel(const T* __restrict__ x, T* __restrict__ out, long long d,
                  long long rows, int block, int k) {
  constexpr int kRowsPerCta = kTopkThreads / G;
  const int lane = threadIdx.x % G;
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerCta + threadIdx.x / G;
  // a group past the last row still runs the shuffles of its warp: it holds
  // no values, counts nothing and stores nothing
  const bool live = row < rows;
  const int width = live ? block : 0;
  const long long base = row * block;
  // the values widened to f32, which is exact: the kept ones are stored
  // back in T unchanged (-0.0 included)
  float a[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int j = i * G + lane;
    const long long flat = base + j;
    a[i] = (j < width && flat < d) ? to_f32(x[flat]) : 0.f;
  }
  const float t = bisect_threshold<PER, G>(a, lane, width, k);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int j = i * G + lane;
    const long long flat = base + j;
    if (j < width && flat < d)
      out[flat] = from_f32<T>(fabsf(a[i]) >= t ? a[i] : 0.f);
  }
}

template <int PER, int G, typename T>
static void launch_topk(const void* x, void* out, long long d, long long rows,
                        int block, int k, cudaStream_t s) {
  constexpr int kRowsPerCta = kTopkThreads / G;
  const unsigned grid =
      static_cast<unsigned>((rows + kRowsPerCta - 1) / kRowsPerCta);
  block_topk_kernel<PER, G, T><<<grid, kTopkThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), d, rows, block, k);
}

// A wide row: one CTA, x kept as f32 in shared memory when STAGED, else
// read again from device memory in every pass (x is never written).
template <bool STAGED, typename T>
__global__ void __launch_bounds__(kWideThreads)
block_topk_wide_kernel(const T* __restrict__ x, T* __restrict__ out,
                       long long d, int block, int k) {
  extern __shared__ __align__(16) float wide_smem[];
  EFK_WIDE_REDUCE(red);
  const long long base = static_cast<long long>(blockIdx.x) * block;
  auto load = [&](int j) {
    const long long flat = base + j;
    return flat < d ? to_f32(x[flat]) : 0.f;      // the pad reads as 0
  };
  auto value = [&](int j) {
    if constexpr (STAGED) return wide_smem[j];
    else return load(j);
  };
  float m = 0.f;
#pragma unroll 4
  for (int j = threadIdx.x; j < block; j += kWideThreads) {
    const float a = load(j);
    if constexpr (STAGED) wide_smem[j] = a;
    m = max_nan(m, fabsf(a));
  }
  const float hi = red.max(m);                  // the row staged, too
  const float t = wide_bisect(hi, block, k, red, [&](float mid) {
    int c = 0;
#pragma unroll 4
    for (int j = threadIdx.x; j < block; j += kWideThreads)
      c += fabsf(value(j)) >= mid ? 1 : 0;
    return c;
  });
#pragma unroll 4
  for (int j = threadIdx.x; j < block; j += kWideThreads) {
    const long long flat = base + j;
    if (flat < d) {
      const float a = value(j);
      out[flat] = from_f32<T>(fabsf(a) >= t ? a : 0.f);
    }
  }
}

template <typename T>
static void launch_topk_wide(const void* x, void* out, long long d,
                             long long rows, int block, int k,
                             cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>(rows);
  auto xx = static_cast<const T*>(x);
  auto oo = static_cast<T*>(out);
  if (wide_layout(block, kTopkWideBytes) == 1) {
    auto kernel = block_topk_wide_kernel<true, T>;
    const int smem = block * kTopkWideBytes;
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess)
      return;                                   // reported by the caller
    kernel<<<grid, kWideThreads, smem, s>>>(xx, oo, d, block, k);
  } else {
    block_topk_wide_kernel<false, T><<<grid, kWideThreads, 0, s>>>(
        xx, oo, d, block, k);
  }
}

template <typename T>
static void launch_topk_width(const void* x, void* out, long long d,
                              long long rows, int block, int k,
                              cudaStream_t s) {
#define EFK_TOPK(PER, G) launch_topk<PER, G, T>(x, out, d, rows, block, k, s)
  if (block <= 1) EFK_TOPK(1, 1);
  else if (block <= 2) EFK_TOPK(1, 2);
  else if (block <= 4) EFK_TOPK(1, 4);
  else if (block <= 8) EFK_TOPK(1, 8);
  else if (block <= 16) EFK_TOPK(1, 16);
  else if (block <= 32) EFK_TOPK(1, 32);
  else if (block <= 64) EFK_TOPK(2, 32);
  else if (block <= 128) EFK_TOPK(4, 32);
  else if (block <= 256) EFK_TOPK(8, 32);
  else if (block <= 512) EFK_TOPK(16, 32);
  else if (block <= kMaxWidth) EFK_TOPK(32, 32);
  else launch_topk_wide<T>(x, out, d, rows, block, k, s);
#undef EFK_TOPK
}

}  // namespace efk

// Returns the cudaError_t of the launch (0 on success). dtype: 0 float32,
// 1 bfloat16, 2 float16; x and out hold d values of that dtype.
extern "C" int ef_launch_block_topk(const void* x, void* out, long long d,
                                    int block, int k, int dtype,
                                    void* stream) {
  using namespace efk;
  const long long rows = block > 0 ? (d + block - 1) / block : 0;
  if (d <= 0 || block <= 0 || k < 1 || k > block || dtype < 0 ||
      dtype > 2 || (block > kMaxWidth && rows > 0x7fffffffLL))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_topk_width<float>(x, out, d, rows, block, k, s);
  else if (dtype == 1)
    launch_topk_width<__nv_bfloat16>(x, out, d, rows, block, k, s);
  else
    launch_topk_width<__half>(x, out, d, rows, block, k, s);
  return static_cast<int>(cudaGetLastError());
}

// The route rows of `block` values take: 0 the lane groups and warps of
// rows up to 1024, 1 the wide route with the row in shared memory, 2 the
// wide route reading the row from device memory each pass.
extern "C" int ef_topk_layout(long long block) {
  return efk::wide_layout(block, efk::kTopkWideBytes);
}
