// One-launch EF round for Hopper (sm_90a): the client uplink mega-kernel and
// the downlink dequantize+add.
//
// ef21_sgdm_topk_quant replaces src/repro/kernels/fused_round.py::
// ef21_sgdm_topk_quant (Pallas TPU kernel _fused_uplink_kernel): per row of
// (rows, width), grad f32 and the EF state v, g f32 or bfloat16, the
// EF21-SGDM chain of ef_update.cu in f32, then per-row absmax quantization
// of the selected c,
//     scale = max|c| * f32(1/qmax),  q = clip(rint(c / safe), -qmax, qmax)
//     g'    = g + q*scale                      (the EF invariant)
// returning (v', g', q, scales): v', g' in the state's type (bf16 rounded to
// nearest even), q int8 (rows, width) for bits=8, packed uint4 (rows,
// width/2) for bits=4 (+8 offset, high nibble first), scales f32.
// Bound: memory. A 4-byte grad read, v and g read and v', g' written in the
// state's type, bits/8 bytes of mantissa an element and one f32 scale a
// row: about 21 bytes an element at bits=8 with f32 state, 13 with bf16.
//
// Design, for rows whose width is a multiple of 8 from 16-byte aligned
// bases: the staged row walk of staged.cuh, which K2 shares (a warp walks
// rows; the next row's grad, v and g arrive by cp.async.bulk during the
// bisection; 16-byte runs of 4 or 8 consecutive values a lane; early-exit
// bisection), with a quantizing epilogue: it reads g back from shared
// memory after the bisection (g is double-buffered there), and at bits 8 a
// lane stores 4 or 8 mantissa bytes at once, at bits 4 a pair's two nibbles
// sit in one lane, with no shuffle, and a lane stores 2 or 4 bytes. Rows of
// another width keep the strided warp-per-row kernel below (ef_update.cu's
// layout, the row and g in registers, 4-byte loads); it takes the early
// exit too. On the fused path's rows the staged kernel reads about 80 % of
// its bound (PERF.md). Rows wider than 1024 (any wider Block-TopK block)
// take the wide route of wide.cuh (one CTA a row, d and g kept in shared
// memory up to 28,672 values, recomputed from the unchanged inputs each
// pass above) with QuantWideEpilogue below: the row's scale is the kept
// set's absmax over the whole row (a CTA-wide max), and at bits 4 a thread
// quantizes both elements of a pair and stores their byte.
//
// dequant_add replaces fused_round.py::dequant_add (_dequant_add_kernel):
//     out = base + alpha*(q*scale)      (alpha applied only when != 1)
// over a flat base of d values laid out as rows of `block` (any width; at
// bits 4 a row holds ceil(block/2) bytes, an odd row's last low nibble
// unused, the layout of block_quantize). Bound: memory, a 4-byte read and a
// 4-byte write an element plus bits/8 bytes of mantissa. Design: one CTA
// per row, threads striding over the row's columns.
//
// Arithmetic: IEEE division for c / safe (__fdiv_rn; never
// --use_fast_math), rounding half to even (rintf), no contraction to FMA
// (__fmul_rn/__fadd_rn), non-finite codec inputs become 0, and the scale
// multiplies by the f32 reciprocal of qmax, which is what the reference's
// `absmax / qmax` compiles to under XLA — what the plain PyTorch versions
// in kernels/ref.py compute, bit for bit.
#include "wide.cuh"

namespace efk {

template <int PER, int BITS, typename S>
__global__ void __launch_bounds__(kRowsPerBlock * kWarp)
ef21_sgdm_topk_quant_kernel(const float* grad, const S* v, const S* g,
                            S* v_out, S* g_out, uint8_t* q_out, float* s_out,
                            long long rows, int width, float c1, float c2,
                            int k) {
  const int lane = threadIdx.x % kWarp;
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= rows) return;  // uniform across the warp
  const long long base = row * width;
  float d[PER], gv[PER];
  momentum_delta<PER>(grad, v, g, v_out, base, lane, width, c1, c2, d, gv);
  const float t = bisect_threshold<PER>(d, lane, width, k);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    float c = fabsf(d[i]) >= t ? d[i] : 0.f;
    d[i] = isfinite(c) ? c : 0.f;  // codec guard: non-finite -> 0
  }
  constexpr float qmax = BITS == 8 ? 127.f : 7.f;
  constexpr float qmax_recip = 1.f / qmax;   // rounded once, at compile time
  const float scale = __fmul_rn(row_absmax<PER>(d, lane, width), qmax_recip);
  const float safe = scale > 0.f ? scale : 1.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int j = i * kWarp + lane;
    float q = rintf(__fdiv_rn(d[i], safe));
    q = fminf(fmaxf(q, -qmax), qmax);
    if (j < width)
      g_out[base + j] = from_f32<S>(__fadd_rn(gv[i], __fmul_rn(q, scale)));
    const int qi = static_cast<int>(q);
    if constexpr (BITS == 8) {
      if (j < width)
        q_out[base + j] = static_cast<uint8_t>(static_cast<int8_t>(qi));
    } else {
      // element j+1 lives on the next lane: pair them into one byte
      const int u = qi + 8;
      const int u_next = __shfl_down_sync(0xffffffffu, u, 1);
      if (j < width && (lane % 2) == 0)
        q_out[row * (width / 2) + j / 2] =
            static_cast<uint8_t>((u << 4) | u_next);
    }
  }
  if (lane == 0) s_out[row] = scale;
}

template <int BITS>
__global__ void dequant_add_kernel(const uint8_t* q, const float* scales,
                                   const float* base, float* out, long long d,
                                   int block, float alpha, int apply_alpha) {
  const long long r = blockIdx.x;
  const float scale = scales[r];
  for (int col = threadIdx.x; col < block; col += blockDim.x) {
    const long long i = r * block + col;
    if (i >= d) break;
    float val;
    if constexpr (BITS == 8) {
      val = static_cast<float>(static_cast<int8_t>(q[i]));
    } else {
      const uint8_t p = q[r * ((block + 1) / 2) + col / 2];
      val = __fsub_rn(static_cast<float>((col % 2) ? (p & 0xF) : (p >> 4)),
                      8.f);
    }
    float dec = __fmul_rn(val, scale);
    if (apply_alpha) dec = __fmul_rn(alpha, dec);
    out[i] = __fadd_rn(base[i], dec);
  }
}

template <int PER, int BITS, typename S>
static void launch_uplink(const float* grad, const void* v, const void* g,
                          void* v_out, void* g_out, uint8_t* q_out,
                          float* s_out, long long rows, int width, float c1,
                          float c2, int k, cudaStream_t s) {
  ef21_sgdm_topk_quant_kernel<PER, BITS, S>
      <<<grid_for_rows(rows), kRowsPerBlock * kWarp, 0, s>>>(
          grad, static_cast<const S*>(v), static_cast<const S*>(g),
          static_cast<S*>(v_out), static_cast<S*>(g_out), q_out, s_out, rows,
          width, c1, c2, k);
}

template <int BITS, typename S>
static void launch_uplink_bits(const float* grad, const void* v,
                               const void* g, void* v_out, void* g_out,
                               uint8_t* q_out, float* s_out, long long rows,
                               int width, float c1, float c2, int k,
                               cudaStream_t s) {
#define EFK_UPLINK(PER)                                                       \
  launch_uplink<PER, BITS, S>(grad, v, g, v_out, g_out, q_out, s_out, rows,  \
                              width, c1, c2, k, s)
  if (width <= 32) EFK_UPLINK(1);
  else if (width <= 64) EFK_UPLINK(2);
  else if (width <= 128) EFK_UPLINK(4);
  else if (width <= 256) EFK_UPLINK(8);
  else if (width <= 512) EFK_UPLINK(16);
  else EFK_UPLINK(32);
#undef EFK_UPLINK
}


// ---- the staged kernel (staged.cuh) with the quantizing epilogue -------

// a run's mantissas: RUN int8 bytes at bits 8, RUN/2 packed bytes at bits
// 4 (+8 offset, the even element in the high nibble), little-endian words
template <int BITS, int RUN>
__device__ __forceinline__ void store_mantissas(uint8_t* q_row, int e0,
                                                const float (&q)[RUN]) {
  if constexpr (BITS == 8) {
    uint32_t w[RUN / 4];
#pragma unroll
    for (int i = 0; i < RUN / 4; ++i) {
      w[i] = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[i] |= (static_cast<uint32_t>(static_cast<int>(q[4 * i + e])) & 0xFFu)
                << (8 * e);
    }
    if constexpr (RUN == 4)
      *reinterpret_cast<uint32_t*>(q_row + e0) = w[0];
    else
      *reinterpret_cast<uint2*>(q_row + e0) = make_uint2(w[0], w[1]);
  } else {
    uint32_t w = 0;
#pragma unroll
    for (int p = 0; p < RUN / 2; ++p) {
      const uint32_t hi = static_cast<uint32_t>(static_cast<int>(q[2 * p]) + 8);
      const uint32_t lo =
          static_cast<uint32_t>(static_cast<int>(q[2 * p + 1]) + 8);
      w |= ((hi << 4) | lo) << (8 * p);
    }
    if constexpr (RUN == 4)
      *reinterpret_cast<uint16_t*>(q_row + e0 / 2) = static_cast<uint16_t>(w);
    else
      *reinterpret_cast<uint32_t*>(q_row + e0 / 2) = w;
  }
}

// c = where(|d| >= t, d, 0) (non-finite -> 0), quantized against the row's
// absmax; g' = g + q*scale, the mantissas and the scale stored
template <int BITS, typename S>
struct QuantEpilogue {
  S* g_out;
  uint8_t* q_out;
  float* s_out;
  int width;

  template <typename R>
  __device__ __forceinline__ void operator()(
      long long row, long long base, float (&d)[Runs<S>::kPer], float t,
      const S* sg, const R& runs) const {
    constexpr int RUN = Runs<S>::kRun, NRUN = Runs<S>::kNRun;
    constexpr int PER = Runs<S>::kPer;
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const float c = fabsf(d[i]) >= t ? d[i] : 0.f;
      d[i] = isfinite(c) ? c : 0.f;            // codec guard: non-finite -> 0
      amax = fmaxf(amax, fabsf(d[i]));
    }
    constexpr float qmax = BITS == 8 ? 127.f : 7.f;
    constexpr float qmax_recip = 1.f / qmax;   // rounded once, at compile time
    const float scale = __fmul_rn(warp_max(amax), qmax_recip);
    const float safe = scale > 0.f ? scale : 1.f;
    uint8_t* q_row = q_out + (BITS == 8 ? base : row * (width / 2));
#pragma unroll
    for (int r = 0; r < NRUN; ++r) {
      const int e0 = runs.first(r);
      if (runs.has(r)) {
        float gg[RUN], q[RUN];
        load_run(sg + e0, gg);
#pragma unroll
        for (int e = 0; e < RUN; ++e) {
          q[e] = fminf(fmaxf(rintf(__fdiv_rn(d[r * RUN + e], safe)), -qmax),
                       qmax);
          gg[e] = __fadd_rn(gg[e], __fmul_rn(q[e], scale));
        }
        store_run(g_out + base + e0, gg);
        store_mantissas<BITS, RUN>(q_row, e0, q);
      }
    }
    if (runs.lane == 0) s_out[row] = scale;
  }
};

template <int BITS, typename S>
static void launch_uplink_staged(const float* grad, const void* v,
                                 const void* g, void* v_out, void* g_out,
                                 uint8_t* q_out, float* s_out, long long rows,
                                 int width, float c1, float c2, int k,
                                 cudaStream_t s) {
  const StagedRows<S> in{grad, static_cast<const S*>(v),
                         static_cast<const S*>(g), static_cast<S*>(v_out),
                         rows, width, c1, c2, k};
  launch_staged(in, QuantEpilogue<BITS, S>{static_cast<S*>(g_out), q_out,
                                           s_out, width}, s);
}

// ---- the wide route (wide.cuh) with the quantizing epilogue -----------

// The last passes of a wide row: the kept set's absmax over the row (one
// CTA-wide max), then q, g' = g + q*scale and the mantissas; at bits 4 a
// thread takes the pair (2p, 2p+1) and stores its byte (+8 offset, the even
// element in the high nibble).
template <int BITS, typename S>
struct QuantWideEpilogue {
  S* g_out;
  uint8_t* q_out;
  float* s_out;

  template <typename Row>
  __device__ __forceinline__ void operator()(long long row, long long base,
                                             float t, const Row& r,
                                             CtaReduce& red) const {
    const int width = r.in.width;
    // c = where(|d| >= t, d, 0), non-finite -> 0 (the codec guard)
    auto kept = [&](float d) {
      const float c = fabsf(d) >= t ? d : 0.f;
      return isfinite(c) ? c : 0.f;
    };
    float amax = 0.f;
#pragma unroll 4
    for (int j = threadIdx.x; j < width; j += kWideThreads)
      amax = fmaxf(amax, fabsf(kept(r.delta(j))));
    constexpr float qmax = BITS == 8 ? 127.f : 7.f;
    constexpr float qmax_recip = 1.f / qmax;   // rounded once, at compile time
    const float scale = __fmul_rn(red.max(amax), qmax_recip);
    const float safe = scale > 0.f ? scale : 1.f;
    // element j's mantissa, with g' stored
    auto quantize = [&](int j) {
      float d, gj;
      r.last(j, d, gj);
      const float q =
          fminf(fmaxf(rintf(__fdiv_rn(kept(d), safe)), -qmax), qmax);
      g_out[base + j] = from_f32<S>(__fadd_rn(gj, __fmul_rn(q, scale)));
      return static_cast<int>(q);
    };
    if constexpr (BITS == 8) {
#pragma unroll 4
      for (int j = threadIdx.x; j < width; j += kWideThreads)
        q_out[base + j] = static_cast<uint8_t>(static_cast<int8_t>(
            quantize(j)));
    } else {
      const int pairs = width / 2;
#pragma unroll 4
      for (int p = threadIdx.x; p < pairs; p += kWideThreads) {
        const int hi = quantize(2 * p) + 8;
        const int lo = quantize(2 * p + 1) + 8;
        q_out[row * pairs + p] = static_cast<uint8_t>((hi << 4) | lo);
      }
    }
    if (threadIdx.x == 0) s_out[row] = scale;
  }
};

template <int BITS, typename S>
static void launch_uplink_wide(const float* grad, const void* v,
                               const void* g, void* v_out, void* g_out,
                               uint8_t* q_out, float* s_out, long long rows,
                               int width, float c1, float c2, int k,
                               cudaStream_t s) {
  const StagedRows<S> in{grad, static_cast<const S*>(v),
                         static_cast<const S*>(g), static_cast<S*>(v_out),
                         rows, width, c1, c2, k};
  launch_wide(in, QuantWideEpilogue<BITS, S>{static_cast<S*>(g_out), q_out,
                                              s_out}, s);
}

}  // namespace efk

// Returns the cudaError_t of the launch (0 on success). v, g, v_out and
// g_out are f32 (state_bf16 = 0) or bfloat16 (state_bf16 = 1); grad is f32.
// v_out/g_out may alias v/g (in-place EF state update).
extern "C" int ef_launch_ef21_sgdm_topk_quant(
    const void* grad, const void* v, const void* g, void* v_out, void* g_out,
    void* q_out, void* s_out, long long rows, int width, float c1, float c2,
    int k, int bits, int state_bf16, void* stream) {
  using namespace efk;
  const int wide = wide_layout(width, kEfWideBytes);
  if (rows <= 0 || width <= 0 || k < 1 || (bits != 8 && bits != 4) ||
      (bits == 4 && width % 2) || (wide && rows > 0x7fffffffLL))
    return static_cast<int>(cudaErrorInvalidValue);
  auto gr = static_cast<const float*>(grad);
  auto qo = static_cast<uint8_t*>(q_out);
  auto so = static_cast<float*>(s_out);
  auto s = static_cast<cudaStream_t>(stream);
  // rows up to 1024 of a multiple of 8 values, every base 16-byte aligned:
  // the staged kernel; other widths up to 1024: the strided one; wider
  // rows: the wide route
  const void* ptrs[6] = {grad, v, g, v_out, g_out, q_out};
  const bool staged = !wide && staged_fits(width, ptrs, 6);
#define EFK_UPLINK_STATE(BITS, S)                                            \
  (wide ? launch_uplink_wide<BITS, S>(gr, v, g, v_out, g_out, qo, so, rows, \
                                      width, c1, c2, k, s)                  \
   : staged ? launch_uplink_staged<BITS, S>(gr, v, g, v_out, g_out, qo, so, \
                                            rows, width, c1, c2, k, s)      \
            : launch_uplink_bits<BITS, S>(gr, v, g, v_out, g_out, qo, so,   \
                                          rows, width, c1, c2, k, s))
  if (bits == 8 && state_bf16) EFK_UPLINK_STATE(8, __nv_bfloat16);
  else if (bits == 8) EFK_UPLINK_STATE(8, float);
  else if (state_bf16) EFK_UPLINK_STATE(4, __nv_bfloat16);
  else EFK_UPLINK_STATE(4, float);
#undef EFK_UPLINK_STATE
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ef_launch_dequant_add(const void* q, const void* scales,
                                     const void* base, void* out,
                                     long long rows, long long d, int block,
                                     int bits, float alpha, int apply_alpha,
                                     void* stream) {
  using namespace efk;
  if (rows <= 0 || d <= 0 || block <= 0 || (bits != 8 && bits != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = block < 256 ? ((block + 31) / 32) * 32 : 256;
  auto qq = static_cast<const uint8_t*>(q);
  auto ss = static_cast<const float*>(scales);
  auto bb = static_cast<const float*>(base);
  auto oo = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (bits == 8)
    dequant_add_kernel<8><<<static_cast<unsigned>(rows), threads, 0, s>>>(
        qq, ss, bb, oo, d, block, alpha, apply_alpha);
  else
    dequant_add_kernel<4><<<static_cast<unsigned>(rows), threads, 0, s>>>(
        qq, ss, bb, oo, d, block, alpha, apply_alpha);
  return static_cast<int>(cudaGetLastError());
}
