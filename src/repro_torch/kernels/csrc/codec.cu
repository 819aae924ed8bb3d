// Wire codec of the quantized carriers for Hopper (sm_90a): per-row absmax
// quantization (K5) and its inverse (K6).
//
// block_quantize replaces src/repro/kernels/quantize.py::block_quantize
// (Pallas TPU kernel _quant_kernel): per row of (rows, cols) f32,
//     x     = isfinite(x) ? x : 0
//     scale = max|x| * f32(1/qmax)          safe = scale > 0 ? scale : 1
//     q     = clip(rint(x / safe), -qmax, qmax)
// returning q int8 (rows, cols) for bits=8, or packed uint4 (rows,
// ceil(cols/2)) for bits=4 (+8 offset, high nibble first; an odd row is
// padded with one zero mantissa), and the scales f32 (rows,).
//
// block_dequantize replaces quantize.py::block_dequantize (_dequant_kernel):
// out = q*scale per row, f32 (rows, cols), the uint4 pad dropped.
//
// Bound: memory. K5 reads 4 bytes and writes bits/8 bytes an element, plus
// one f32 scale a row; K6 reads bits/8 bytes and writes 4 an element.
// Design: row widths on the carriers' paths run from 16 (the uplink's sparse
// payload) to millions (plain TopK's single block spanning a leaf), so the
// launcher picks one of two mappings:
//   narrow rows (up to 1024): a group of G lanes a row, G the row's width
//     rounded up to a power of two and capped at a warp, 256/G rows a
//     256-thread CTA (two rows of 16 a warp, one row of 51 or 256 a warp);
//     the absmax is a shuffle reduction inside the group, no barrier;
//   wide rows: one CTA a row, up to 1024 threads, the absmax a block-wide
//     reduction (warp shuffles, then one shared-memory slot a warp).
// Either way the lanes stride over the row's columns; K5 makes two passes
// over its row: the absmax, then the mantissas.
//
// Arithmetic: IEEE division (__fdiv_rn; never --use_fast_math), rounding
// half to even (rintf), the scale as a multiply by the f32 reciprocal of
// qmax (what the reference's `absmax / qmax` compiles to under XLA), and
// __fmul_rn/__fsub_rn in the decode: what kernels/ref.py::
// block_quantize_plain and block_dequantize_plain compute, bit for bit.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace efk_codec {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float finite_or_zero(float x) {
  return isfinite(x) ? x : 0.f;
}

// max of v over the CTA (blockDim.x a multiple of 32); every thread gets it
__device__ __forceinline__ float block_max(float v) {
  __shared__ float warp_max[kMaxThreads / kWarp];
  const int lane = threadIdx.x % kWarp;
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) warp_max[threadIdx.x / kWarp] = v;
  __syncthreads();
  const int nwarps = blockDim.x / kWarp;
  v = lane < nwarps ? warp_max[lane] : 0.f;
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int BITS>
__device__ __forceinline__ int quantize_one(float x, float safe) {
  constexpr float qmax = BITS == 8 ? 127.f : 7.f;
  const float q = rintf(__fdiv_rn(finite_or_zero(x), safe));
  return static_cast<int>(fminf(fmaxf(q, -qmax), qmax));
}

// Both mappings share the passes over one row r: the lanes take the
// columns (or uint4 pairs) first, first + stride, ...

template <int BITS>
__device__ __forceinline__ void write_mantissas(const float* row, uint8_t* q,
                                                long long r, int cols,
                                                float safe, int first,
                                                int stride) {
  if constexpr (BITS == 8) {
    int8_t* qr = reinterpret_cast<int8_t*>(q) + r * cols;
    for (int j = first; j < cols; j += stride)
      qr[j] = static_cast<int8_t>(quantize_one<8>(row[j], safe));
  } else {
    const int pairs = (cols + 1) / 2;
    uint8_t* qr = q + r * pairs;
    for (int p = first; p < pairs; p += stride) {
      const int j = 2 * p;
      const int hi = quantize_one<4>(row[j], safe) + 8;
      const int lo = j + 1 < cols ? quantize_one<4>(row[j + 1], safe) + 8 : 8;
      qr[p] = static_cast<uint8_t>((hi << 4) | lo);
    }
  }
}

template <int BITS>
__device__ __forceinline__ void write_values(const uint8_t* q, float scale,
                                             float* out, long long r,
                                             int cols, int first, int stride) {
  float* orow = out + r * cols;
  if constexpr (BITS == 8) {
    const int8_t* qr = reinterpret_cast<const int8_t*>(q) + r * cols;
    for (int j = first; j < cols; j += stride)
      orow[j] = __fmul_rn(static_cast<float>(qr[j]), scale);
  } else {
    const uint8_t* qr = q + r * ((cols + 1) / 2);
    for (int j = first; j < cols; j += stride) {
      const uint8_t p = qr[j / 2];
      const float v = __fsub_rn(static_cast<float>((j % 2) ? (p & 0xF) : (p >> 4)),
                                8.f);
      orow[j] = __fmul_rn(v, scale);
    }
  }
}

template <int BITS>
__device__ __forceinline__ float scale_of(float absmax) {
  constexpr float qmax_recip = 1.f / (BITS == 8 ? 127.f : 7.f);
  return __fmul_rn(absmax, qmax_recip);
}

// ---- narrow rows: a group of G lanes (a power of two, at most a warp) a row

// the row of this thread's group, and its lane in the group
struct Group {
  long long row;
  int lane;
};

__device__ __forceinline__ Group group_of(int g) {
  return {static_cast<long long>(blockIdx.x) * (blockDim.x / g) +
              threadIdx.x / g,
          static_cast<int>(threadIdx.x % g)};
}

template <int BITS>
__global__ void block_quantize_narrow(const float* __restrict__ x,
                                      uint8_t* __restrict__ q,
                                      float* __restrict__ scales,
                                      long long rows, int cols, int g) {
  const Group grp = group_of(g);
  const bool live = grp.row < rows;
  const float* row = x + grp.row * cols;
  float m = 0.f;
  if (live)
    for (int j = grp.lane; j < cols; j += g)
      m = fmaxf(m, fabsf(finite_or_zero(row[j])));
  // every lane of the warp takes part; xor offsets below g stay in the group
  for (int o = g / 2; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (!live) return;
  const float scale = scale_of<BITS>(m);
  write_mantissas<BITS>(row, q, grp.row, cols, scale > 0.f ? scale : 1.f,
                        grp.lane, g);
  if (grp.lane == 0) scales[grp.row] = scale;
}

template <int BITS>
__global__ void block_dequantize_narrow(const uint8_t* __restrict__ q,
                                        const float* __restrict__ scales,
                                        float* __restrict__ out,
                                        long long rows, int cols, int g) {
  const Group grp = group_of(g);
  if (grp.row >= rows) return;
  write_values<BITS>(q, scales[grp.row], out, grp.row, cols, grp.lane, g);
}

// ---- wide rows: one CTA a row

template <int BITS>
__global__ void block_quantize_kernel(const float* __restrict__ x,
                                      uint8_t* __restrict__ q,
                                      float* __restrict__ scales, int cols) {
  const long long r = blockIdx.x;
  const float* row = x + r * cols;
  float m = 0.f;
  for (int j = threadIdx.x; j < cols; j += blockDim.x)
    m = fmaxf(m, fabsf(finite_or_zero(row[j])));
  const float scale = scale_of<BITS>(block_max(m));
  write_mantissas<BITS>(row, q, r, cols, scale > 0.f ? scale : 1.f,
                        threadIdx.x, blockDim.x);
  if (threadIdx.x == 0) scales[r] = scale;
}

template <int BITS>
__global__ void block_dequantize_kernel(const uint8_t* __restrict__ q,
                                        const float* __restrict__ scales,
                                        float* __restrict__ out, int cols) {
  const long long r = blockIdx.x;
  write_values<BITS>(q, scales[r], out, r, cols, threadIdx.x, blockDim.x);
}

constexpr int kNarrowMax = 1024;   // widest row a group of lanes takes
constexpr int kNarrowThreads = 256;

// lanes a row on the narrow mapping: cols rounded up to a power of two, at
// most a warp
inline int group_for(int cols) {
  int g = 1;
  while (g < cols && g < kWarp) g <<= 1;
  return g;
}

// threads a CTA on the wide mapping: 256 up to rows of 8191, then 1024
inline int threads_for(int cols) {
  return cols >= 8192 ? kMaxThreads : 256;
}

inline bool bad_shape(long long rows, int cols, int bits) {
  return rows <= 0 || rows > INT_MAX || cols <= 0 || (bits != 8 && bits != 4);
}

}  // namespace efk_codec

// Both return the cudaError_t of the launch (0 on success).
extern "C" int ef_launch_block_quantize(const void* x, void* q, void* scales,
                                        long long rows, int cols, int bits,
                                        void* stream) {
  using namespace efk_codec;
  if (bad_shape(rows, cols, bits))
    return static_cast<int>(cudaErrorInvalidValue);
  auto xx = static_cast<const float*>(x);
  auto qq = static_cast<uint8_t*>(q);
  auto ss = static_cast<float*>(scales);
  auto s = static_cast<cudaStream_t>(stream);
  if (cols <= kNarrowMax) {
    const int g = group_for(cols);
    const long long per_cta = kNarrowThreads / g;
    const unsigned grid = static_cast<unsigned>((rows + per_cta - 1) / per_cta);
    if (bits == 8)
      block_quantize_narrow<8><<<grid, kNarrowThreads, 0, s>>>(xx, qq, ss,
                                                               rows, cols, g);
    else
      block_quantize_narrow<4><<<grid, kNarrowThreads, 0, s>>>(xx, qq, ss,
                                                               rows, cols, g);
  } else {
    const unsigned grid = static_cast<unsigned>(rows);
    const int threads = threads_for(cols);
    if (bits == 8)
      block_quantize_kernel<8><<<grid, threads, 0, s>>>(xx, qq, ss, cols);
    else
      block_quantize_kernel<4><<<grid, threads, 0, s>>>(xx, qq, ss, cols);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ef_launch_block_dequantize(const void* q, const void* scales,
                                          void* out, long long rows, int cols,
                                          int bits, void* stream) {
  using namespace efk_codec;
  if (bad_shape(rows, cols, bits))
    return static_cast<int>(cudaErrorInvalidValue);
  auto qq = static_cast<const uint8_t*>(q);
  auto ss = static_cast<const float*>(scales);
  auto oo = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (cols <= kNarrowMax) {
    const int g = group_for(cols);
    const long long per_cta = kNarrowThreads / g;
    const unsigned grid = static_cast<unsigned>((rows + per_cta - 1) / per_cta);
    if (bits == 8)
      block_dequantize_narrow<8><<<grid, kNarrowThreads, 0, s>>>(qq, ss, oo,
                                                                 rows, cols, g);
    else
      block_dequantize_narrow<4><<<grid, kNarrowThreads, 0, s>>>(qq, ss, oo,
                                                                 rows, cols, g);
  } else {
    const unsigned grid = static_cast<unsigned>(rows);
    const int threads = threads_for(cols);
    if (bits == 8)
      block_dequantize_kernel<8><<<grid, threads, 0, s>>>(qq, ss, oo, cols);
    else
      block_dequantize_kernel<4><<<grid, threads, 0, s>>>(qq, ss, oo, cols);
  }
  return static_cast<int>(cudaGetLastError());
}
