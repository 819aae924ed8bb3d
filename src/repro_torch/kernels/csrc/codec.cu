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
// payload) to millions (plain TopK's single block spanning a leaf). The
// launcher picks one of three mappings by shape and alignment (mapping_for;
// ef_codec_mapping asks the same rule from outside):
//   vector (cols a multiple of 4, at most 1024; x for K5, q for K6, and the
//     outputs on 16-byte boundaries): a group of G lanes a row, G the
//     row's float4 count rounded up to a power of two and capped at a warp
//     (4 lanes a row of 16, a warp a row of 256 or 1024); a lane loads its
//     float4s of the row with 16-byte loads, all before the absmax, keeps
//     them in registers (the row is read once), and stores its mantissas
//     packed: 4 bytes (bits 8) or 2 (bits 4) a float4, so a warp writes
//     whole runs of 128 or 64 bytes; K6 loads those and stores float4s.
//     K5's groups walk rows in a grid-stride loop sized to the card's
//     resident CTAs, the next row's loads issued before this row's
//     absmax, so two rows a lane are in flight; K6 takes one row a group;
//   scalar (any other width up to 1024: 51 on path A's downlink): a group
//     of G lanes a row, G the row's width (uint4 pairs at bits 4) rounded
//     up to a power of two and capped at a warp; K5's lanes hold their
//     values in registers, so it too reads the row once;
//   wide rows: one CTA a row, up to 1024 threads, the absmax a block-wide
//     reduction (warp shuffles, then one shared-memory slot a warp), then
//     a second pass over the row for the mantissas.
// In the vector and scalar mappings the group's absmax is a shuffle
// reduction, with no barrier.
//
// Arithmetic: IEEE division (__fdiv_rn; never --use_fast_math), rounding
// half to even (rintf), the scale as a multiply by the f32 reciprocal of
// qmax (what the reference's `absmax / qmax` compiles to under XLA), and
// __fmul_rn/__fsub_rn in the decode: what kernels/ref.py::
// block_quantize_plain and block_dequantize_plain compute, bit for bit.
// The order in which a row's values meet in the absmax does not matter:
// max is exact.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

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

// The passes over one row r of the wide mapping (K6's scalar mapping takes
// write_values too): the lanes take the columns (or uint4 pairs) first,
// first + stride, ...

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

// a row a group of g lanes: the row of this thread's group, and its lane
// in the group
struct Group {
  long long row;
  int lane;
};

__device__ __forceinline__ Group group_of(int g) {
  return {static_cast<long long>(blockIdx.x) * (blockDim.x / g) +
              threadIdx.x / g,
          static_cast<int>(threadIdx.x % g)};
}

// ---- the vector mapping: G lanes a row, float4s in registers

// One row's float4s of this lane: j = lane, lane + g, ... below nvec; zeros
// where there is none (a lane beyond the row, or a row beyond the last).
template <int V>
__device__ __forceinline__ void load_row(const float4* __restrict__ x,
                                         long long r, bool live, int nvec,
                                         int lane, int g, float4 (&v)[V]) {
  const float4* row = x + r * nvec;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int j = lane + i * g;
    v[i] = live && j < nvec ? __ldg(row + j) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ __forceinline__ float absmax4(float m, float4 a) {
  m = fmaxf(m, fabsf(finite_or_zero(a.x)));
  m = fmaxf(m, fabsf(finite_or_zero(a.y)));
  m = fmaxf(m, fabsf(finite_or_zero(a.z)));
  return fmaxf(m, fabsf(finite_or_zero(a.w)));
}

// K5's grid-stride walk on the vector mapping. Rows are handed out a warp at
// a time (its 32/g groups take consecutive rows), so every lane of a warp
// runs the same iterations and the shuffles see the whole warp.
struct Walk {
  long long first;    // this group's first row
  long long stride;   // rows between two of its iterations
  int lane;           // lane in the group
};

__device__ __forceinline__ Walk walk_of(int g) {
  const long long groups_per_cta = blockDim.x / g;
  return {static_cast<long long>(blockIdx.x) * groups_per_cta +
              threadIdx.x / g,
          static_cast<long long>(gridDim.x) * groups_per_cta,
          static_cast<int>(threadIdx.x % g)};
}

// the first row of this lane's warp in the iteration whose row is r
__device__ __forceinline__ long long warp_row(long long r, int g) {
  return r - (threadIdx.x % kWarp) / g;
}

template <int BITS, int V>
__global__ void __launch_bounds__(256)
block_quantize_vector(const float4* __restrict__ x, uint8_t* __restrict__ q,
                      float* __restrict__ scales, long long rows, int nvec,
                      int g) {
  const Walk w = walk_of(g);
  float4 cur[V], nxt[V];
  long long r = w.first;
  load_row<V>(x, r, r < rows, nvec, w.lane, g, cur);
  for (; warp_row(r, g) < rows; r += w.stride) {
    const bool live = r < rows;
    // the next row's loads go out before this row's reduction
    load_row<V>(x, r + w.stride, r + w.stride < rows, nvec, w.lane, g, nxt);
    float m = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) m = absmax4(m, cur[i]);
    for (int o = g / 2; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (live) {
      const float scale = scale_of<BITS>(m);
      const float safe = scale > 0.f ? scale : 1.f;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int j = w.lane + i * g;
        if (j >= nvec) break;
        const int a = quantize_one<BITS>(cur[i].x, safe);
        const int b = quantize_one<BITS>(cur[i].y, safe);
        const int c = quantize_one<BITS>(cur[i].z, safe);
        const int d = quantize_one<BITS>(cur[i].w, safe);
        if constexpr (BITS == 8) {
          // element 4j + t at byte t: the int8 layout, little-endian
          const uint32_t packed = (a & 0xFF) | (b & 0xFF) << 8 |
                                  (c & 0xFF) << 16 |
                                  static_cast<uint32_t>(d & 0xFF) << 24;
          reinterpret_cast<uint32_t*>(q)[r * nvec + j] = packed;
        } else {
          // pairs (4j, 4j+1), (4j+2, 4j+3): +8, high nibble first
          const uint32_t lo = static_cast<uint32_t>((a + 8) << 4 | (b + 8));
          const uint32_t hi = static_cast<uint32_t>((c + 8) << 4 | (d + 8));
          reinterpret_cast<uint16_t*>(q)[r * nvec + j] =
              static_cast<uint16_t>(lo | hi << 8);
        }
      }
      if (w.lane == 0) scales[r] = scale;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) cur[i] = nxt[i];
  }
}

// K6's lane loads the mantissas of its float4s: 4 bytes at bits 8, 2 at 4
template <int BITS>
using Packed = typename std::conditional<BITS == 8, uint32_t, uint16_t>::type;

template <int BITS>
__device__ __forceinline__ float4 decode4(Packed<BITS> p, float scale) {
  float e[4];
  if constexpr (BITS == 8) {
#pragma unroll
    for (int t = 0; t < 4; ++t)
      e[t] = static_cast<float>(static_cast<int8_t>(p >> (8 * t)));
  } else {
    // byte t/2 holds pair t/2: the high nibble first
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const uint32_t byte = (p >> (8 * (t / 2))) & 0xFF;
      e[t] = __fsub_rn(static_cast<float>(t % 2 ? byte & 0xF : byte >> 4),
                       8.f);
    }
  }
  return make_float4(__fmul_rn(e[0], scale), __fmul_rn(e[1], scale),
                     __fmul_rn(e[2], scale), __fmul_rn(e[3], scale));
}

// K6's vector mapping takes one row a group and no grid-stride walk: its
// traffic is mostly stores, which need no loads in flight; timed on an
// H100, the walk helped K5 (mostly loads) and slowed K6.
template <int BITS, int V>
__global__ void __launch_bounds__(256)
block_dequantize_vector(const Packed<BITS>* __restrict__ q,
                        const float* __restrict__ scales,
                        float4* __restrict__ out, long long rows, int nvec,
                        int g) {
  const Group grp = group_of(g);
  if (grp.row >= rows) return;
  const Packed<BITS>* qr = q + grp.row * nvec;
  float4* orow = out + grp.row * nvec;
  const float scale = __ldg(scales + grp.row);
  Packed<BITS> p[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int j = grp.lane + i * g;
    p[i] = j < nvec ? __ldg(qr + j) : 0;
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int j = grp.lane + i * g;
    if (j < nvec) orow[j] = decode4<BITS>(p[i], scale);
  }
}

// ---- the scalar mapping: G lanes a row, K5's values in registers

// A lane holds PER units of the row: units u = lane, lane + g, ...; a unit
// is one value at bits 8 and one uint4 pair at bits 4.
template <int BITS, int PER>
__global__ void block_quantize_scalar(const float* __restrict__ x,
                                      uint8_t* __restrict__ q,
                                      float* __restrict__ scales,
                                      long long rows, int cols, int g) {
  constexpr int U = BITS == 8 ? 1 : 2;              // values a unit
  const Group grp = group_of(g);
  const bool live = grp.row < rows;
  const int units = (cols + U - 1) / U;
  const float* row = x + grp.row * cols;
  float v[PER * U];
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int u = grp.lane + i * g;
#pragma unroll
    for (int t = 0; t < U; ++t) {
      const int j = u * U + t;
      v[i * U + t] = live && u < units && j < cols
                         ? finite_or_zero(row[j]) : 0.f;
      m = fmaxf(m, fabsf(v[i * U + t]));
    }
  }
  // every lane of the warp takes part; xor offsets below g stay in the group
  for (int o = g / 2; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (!live) return;
  const float scale = scale_of<BITS>(m);
  const float safe = scale > 0.f ? scale : 1.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int u = grp.lane + i * g;
    if (u >= units) break;
    if constexpr (BITS == 8) {
      reinterpret_cast<int8_t*>(q)[grp.row * cols + u] =
          static_cast<int8_t>(quantize_one<8>(v[i], safe));
    } else {
      // the pad value of an odd row is 0: its mantissa is 0 + 8
      const int hi = quantize_one<4>(v[2 * i], safe) + 8;
      const int lo = quantize_one<4>(v[2 * i + 1], safe) + 8;
      q[grp.row * units + u] = static_cast<uint8_t>((hi << 4) | lo);
    }
  }
  if (grp.lane == 0) scales[grp.row] = scale;
}

template <int BITS>
__global__ void block_dequantize_scalar(const uint8_t* __restrict__ q,
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

// the mappings, by their code in the C interface (ef_codec_mapping)
enum Mapping { kVector = 0, kScalar = 1, kWide = 2 };

constexpr int kNarrowMax = 1024;   // widest row a group of lanes takes
constexpr int kNarrowThreads = 256;

// lanes a row: n (float4s, values or pairs) rounded up to a power of two,
// at most a warp
inline int group_for(int n) {
  int g = 1;
  while (g < n && g < kWarp) g <<= 1;
  return g;
}

// what a lane holds: n over g rounded up to a power of two
inline int per_lane(int n, int g) {
  int p = 1;
  while (p * g < n) p <<= 1;
  return p;
}

// threads a CTA on the wide mapping: 256 up to rows of 8191, then 1024
inline int threads_for(int cols) {
  return cols >= 8192 ? kMaxThreads : 256;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The mapping rows of `cols` values run on, from the width and the
// alignment of the rows read (`in`) and written (`out`).
inline int mapping_for(int cols, const void* in, const void* out) {
  if (cols > kNarrowMax) return kWide;
  return cols % 4 == 0 && aligned16(in) && aligned16(out) ? kVector
                                                          : kScalar;
}

inline bool bad_call(long long rows, int cols, int bits) {
  return rows <= 0 || rows > INT_MAX || cols <= 0 || (bits != 8 && bits != 4);
}

// CTAs of the vector mapping: enough for every row, at most what the card
// holds at once (the groups then walk the rows). ``per_sm`` is the kernel's
// resident CTAs an SM; the SM count is read once a process.
inline unsigned vector_grid(long long rows, int g, int per_sm) {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  const long long per_cta = kNarrowThreads / g;
  const long long need = (rows + per_cta - 1) / per_cta;
  const long long most = static_cast<long long>(sms > 0 ? sms : 1) *
                         (per_sm > 0 ? per_sm : 1);
  return static_cast<unsigned>(need < most ? need : most);
}

template <typename Kernel>
int resident_ctas(Kernel kernel) {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kNarrowThreads, 0);
  return n;
}

template <int BITS, int V>
void launch_quantize_vector(const float* x, uint8_t* q, float* scales,
                            long long rows, int cols, cudaStream_t s) {
  const int nvec = cols / 4, g = group_for(nvec);
  static const int per_sm = resident_ctas(block_quantize_vector<BITS, V>);
  block_quantize_vector<BITS, V><<<vector_grid(rows, g, per_sm),
                                   kNarrowThreads, 0, s>>>(
      reinterpret_cast<const float4*>(x), q, scales, rows, nvec, g);
}

template <int BITS, int V>
void launch_dequantize_vector(const uint8_t* q, const float* scales,
                              float* out, long long rows, int cols,
                              cudaStream_t s) {
  const int nvec = cols / 4, g = group_for(nvec);
  const long long per_cta = kNarrowThreads / g;
  const unsigned grid = static_cast<unsigned>((rows + per_cta - 1) / per_cta);
  block_dequantize_vector<BITS, V><<<grid, kNarrowThreads, 0, s>>>(
      reinterpret_cast<const Packed<BITS>*>(q), scales,
      reinterpret_cast<float4*>(out), rows, nvec, g);
}

template <int BITS, int PER>
void launch_quantize_scalar(const float* x, uint8_t* q, float* scales,
                            long long rows, int cols, int g, cudaStream_t s) {
  const long long per_cta = kNarrowThreads / g;
  const unsigned grid = static_cast<unsigned>((rows + per_cta - 1) / per_cta);
  block_quantize_scalar<BITS, PER><<<grid, kNarrowThreads, 0, s>>>(
      x, q, scales, rows, cols, g);
}

template <int BITS>
void quantize(const float* x, uint8_t* q, float* scales, long long rows,
              int cols, int mapping, cudaStream_t s) {
  if (mapping == kVector) {
    const int nvec = cols / 4;
    switch (per_lane(nvec, group_for(nvec))) {
      case 1: return launch_quantize_vector<BITS, 1>(x, q, scales, rows, cols, s);
      case 2: return launch_quantize_vector<BITS, 2>(x, q, scales, rows, cols, s);
      case 4: return launch_quantize_vector<BITS, 4>(x, q, scales, rows, cols, s);
      default: return launch_quantize_vector<BITS, 8>(x, q, scales, rows, cols, s);
    }
  }
  if (mapping == kScalar) {
    const int units = BITS == 8 ? cols : (cols + 1) / 2;
    const int g = group_for(units);
    switch (per_lane(units, g)) {
      case 1: return launch_quantize_scalar<BITS, 1>(x, q, scales, rows, cols, g, s);
      case 2: return launch_quantize_scalar<BITS, 2>(x, q, scales, rows, cols, g, s);
      case 4: return launch_quantize_scalar<BITS, 4>(x, q, scales, rows, cols, g, s);
      case 8: return launch_quantize_scalar<BITS, 8>(x, q, scales, rows, cols, g, s);
      case 16: return launch_quantize_scalar<BITS, 16>(x, q, scales, rows, cols, g, s);
      default: return launch_quantize_scalar<BITS, 32>(x, q, scales, rows, cols, g, s);
    }
  }
  block_quantize_kernel<BITS><<<static_cast<unsigned>(rows), threads_for(cols),
                                0, s>>>(x, q, scales, cols);
}

template <int BITS>
void dequantize(const uint8_t* q, const float* scales, float* out,
                long long rows, int cols, int mapping, cudaStream_t s) {
  if (mapping == kVector) {
    const int nvec = cols / 4;
    switch (per_lane(nvec, group_for(nvec))) {
      case 1: return launch_dequantize_vector<BITS, 1>(q, scales, out, rows, cols, s);
      case 2: return launch_dequantize_vector<BITS, 2>(q, scales, out, rows, cols, s);
      case 4: return launch_dequantize_vector<BITS, 4>(q, scales, out, rows, cols, s);
      default: return launch_dequantize_vector<BITS, 8>(q, scales, out, rows, cols, s);
    }
  }
  if (mapping == kScalar) {
    const int g = group_for(cols);
    const long long per_cta = kNarrowThreads / g;
    const unsigned grid = static_cast<unsigned>((rows + per_cta - 1) / per_cta);
    block_dequantize_scalar<BITS><<<grid, kNarrowThreads, 0, s>>>(
        q, scales, out, rows, cols, g);
    return;
  }
  block_dequantize_kernel<BITS><<<static_cast<unsigned>(rows),
                                  threads_for(cols), 0, s>>>(q, scales, out,
                                                             cols);
}

}  // namespace efk_codec

// Both return the cudaError_t of the launch (0 on success).
extern "C" int ef_launch_block_quantize(const void* x, void* q, void* scales,
                                        long long rows, int cols, int bits,
                                        void* stream) {
  using namespace efk_codec;
  if (bad_call(rows, cols, bits))
    return static_cast<int>(cudaErrorInvalidValue);
  const int mapping = mapping_for(cols, x, q);
  auto xx = static_cast<const float*>(x);
  auto qq = static_cast<uint8_t*>(q);
  auto ss = static_cast<float*>(scales);
  auto s = static_cast<cudaStream_t>(stream);
  if (bits == 8)
    quantize<8>(xx, qq, ss, rows, cols, mapping, s);
  else
    quantize<4>(xx, qq, ss, rows, cols, mapping, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ef_launch_block_dequantize(const void* q, const void* scales,
                                          void* out, long long rows, int cols,
                                          int bits, void* stream) {
  using namespace efk_codec;
  if (bad_call(rows, cols, bits))
    return static_cast<int>(cudaErrorInvalidValue);
  const int mapping = mapping_for(cols, q, out);
  auto qq = static_cast<const uint8_t*>(q);
  auto ss = static_cast<const float*>(scales);
  auto oo = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (bits == 8)
    dequantize<8>(qq, ss, oo, rows, cols, mapping, s);
  else
    dequantize<4>(qq, ss, oo, rows, cols, mapping, s);
  return static_cast<int>(cudaGetLastError());
}

// The mapping K5 (in x, out q) or K6 (in q, out the f32 rows) runs rows of
// `cols` values on: 0 vector, 1 scalar, 2 wide.
extern "C" int ef_codec_mapping(const void* in, const void* out, int cols) {
  return efk_codec::mapping_for(cols, in, out);
}
