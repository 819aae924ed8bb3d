// The staged row walk shared by the EF client kernels K2 (ef_update.cu) and
// K3 (fused_round.cu), for rows whose width is a multiple of 8 with every
// base on a 16-byte boundary (every carrier row: the selection block, 1024,
// with a leaf's pad as zeros in the state).
//
// Per row of (rows, width), grad f32 and the EF state v, g f32 or bfloat16:
//     v' = c1*v + c2*grad        stored at once, in the state's type
//     d  = v' - g                from the f32 v' (before that rounding)
//     t  = the 26-step threshold of |d| (bisect.cuh, early exit)
// then the kernel's epilogue, the only part in which K2 and K3 differ: K2
// stores c = where(|d| >= t, d, 0) and g' = g + c, K3 quantizes c and
// stores g' = g + q*scale with the mantissas and the row's scale.
//
// Design:
//   - a warp walks rows (grid-stride over a grid that fills the card once);
//     while it bisects row i, the next row's grad, v and g are on their way
//     into shared memory by 1-D bulk copies (cp.async.bulk, one mbarrier a
//     warp). grad and v are single-buffered (they are read once, before the
//     bisection, so the next row may overwrite them), g double-buffered (it
//     is read after the bisection, by the epilogue, instead of being held
//     in registers through it). Shared memory, 16 KB a warp with f32 state
//     and 10 KB with bf16, not registers, sets the residency: 12 and 20
//     warps an SM, each with one row of copies in flight, several times the
//     bytes the HBM rate needs in flight;
//   - lane l holds runs of 4 (f32 state) or 8 (bf16) consecutive values,
//     runs l, l+32, ...: every shared-memory load and every store of the
//     state's type is 16 bytes;
//   - a full row (width 1024) counts with no presence test; a narrower row
//     tests presence a run at a time.
// Counts and maxima do not depend on where an element sits, so the outputs
// are bit-identical to the strided warp-per-row layout's. Each element is
// staged before anything is stored to it, and rows are disjoint, so outputs
// may alias inputs element for element (the in-place EF state update).
#pragma once

#include "bisect.cuh"
#include "hopper.cuh"

namespace efk {

constexpr int kStagedWarps = 4;     // warps a CTA, each walking its own rows

template <typename S>
struct Runs {
  static constexpr int kRun = 16 / static_cast<int>(sizeof(S));  // 4 or 8
  static constexpr int kNRun = kMaxWidth / (kWarp * kRun);       // 8 or 4
  static constexpr int kPer = kRun * kNRun;                      // 32
};

// shared memory of one warp: grad (f32), v, and g twice, `width` each
template <typename S>
__host__ __device__ constexpr int staged_warp_bytes(int width) {
  return width * (4 + 3 * static_cast<int>(sizeof(S)));
}

// rows of `width` from these bases take the staged kernel
inline bool staged_fits(int width, const void* const* ptrs, int n) {
  bool ok = width % 8 == 0;
  for (int i = 0; i < n; ++i)
    ok = ok && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0;
  return ok;
}

__device__ __forceinline__ void load_run(const float* p, float (&x)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}
__device__ __forceinline__ void load_run(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load_run(const __nv_bfloat16* p,
                                         float (&x)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    x[2 * e] = f.x;
    x[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void store_run(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store_run(__nv_bfloat16* p,
                                          const float (&x)[8]) {
  uint4 a;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    h[e] = __floats2bfloat162_rn(x[2 * e], x[2 * e + 1]);
  *reinterpret_cast<uint4*>(p) = a;
}

// The inputs every staged launch shares.
template <typename S>
struct StagedRows {
  const float* grad;
  const S* v;
  const S* g;
  S* v_out;
  long long rows;
  int width;
  float c1, c2;
  int k;
};

// The runs of one row that a lane holds: run r of the lane starts at
// element first(r) and holds present values when has(r).
template <bool FULL, typename S>
struct LaneRuns {
  int lane, nruns;
  __device__ __forceinline__ bool has(int r) const {
    return FULL || r * kWarp + lane < nruns;
  }
  __device__ __forceinline__ int first(int r) const {
    return (r * kWarp + lane) * Runs<S>::kRun;
  }
};

// The walk. `epi(row, base, d, t, sg, runs)` finishes a row: d holds v' - g
// (0 where absent), t the threshold, sg the row's g in shared memory.
template <bool FULL, typename S, typename Epilogue>
__global__ void __launch_bounds__(kStagedWarps * kWarp, 5)
staged_rows_kernel(const StagedRows<S> in, const Epilogue epi) {
  constexpr int RUN = Runs<S>::kRun, NRUN = Runs<S>::kNRun;
  constexpr int PER = Runs<S>::kPer;
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x % kWarp, wid = threadIdx.x / kWarp;
  const int width = in.width;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem) + wid;
  uint8_t* buf = smem + kStagedWarps * sizeof(uint64_t) +
                 wid * staged_warp_bytes<S>(width);
  float* s_grad = reinterpret_cast<float*>(buf);
  S* s_v = reinterpret_cast<S*>(buf + width * 4);
  S* s_g = s_v + width;                       // two buffers of width
  const LaneRuns<FULL, S> runs{lane, width / RUN};
  const uint32_t grad_bytes = width * 4;
  const uint32_t state_bytes = width * static_cast<int>(sizeof(S));
  const long long stride = static_cast<long long>(gridDim.x) * kStagedWarps;
  long long row = static_cast<long long>(blockIdx.x) * kStagedWarps + wid;
  auto stage = [&](long long r, int slot) {   // lane 0 only
    hop::mbar_arrive_expect_tx(bar, grad_bytes + 2 * state_bytes);
    hop::bulk_load(s_grad, in.grad + r * width, grad_bytes, bar);
    hop::bulk_load(s_v, in.v + r * width, state_bytes, bar);
    hop::bulk_load(s_g + slot * width, in.g + r * width, state_bytes, bar);
  };

  if (lane == 0) {
    hop::mbar_init(bar, 1);
    hop::fence_barrier_init();
    if (row < in.rows) stage(row, 0);
  }
  __syncwarp();
  for (int j = 0; row < in.rows; ++j, row += stride) {
    hop::mbar_wait(bar, j & 1);
    const S* sg = s_g + (j & 1) * width;
    const long long base = row * width;

    // v' = c1*v + c2*grad (stored now), d = v' - g
    float d[PER];
#pragma unroll
    for (int r = 0; r < NRUN; ++r) {
      const int e0 = runs.first(r);
      if (runs.has(r)) {
        float gr[RUN], vv[RUN], gg[RUN], vn[RUN];
        load_run(s_grad + e0, gr);
        load_run(s_v + e0, vv);
        load_run(sg + e0, gg);
#pragma unroll
        for (int e = 0; e < RUN; ++e) {
          vn[e] = __fadd_rn(__fmul_rn(in.c1, vv[e]), __fmul_rn(in.c2, gr[e]));
          d[r * RUN + e] = __fsub_rn(vn[e], gg[e]);
        }
        store_run(in.v_out + base + e0, vn);
      } else {
#pragma unroll
        for (int e = 0; e < RUN; ++e) d[r * RUN + e] = 0.f;
      }
    }
    // grad and v are consumed: the next row's copies run during the
    // bisection (into the other g buffer)
    hop::fence_proxy_async();
    __syncwarp();
    if (lane == 0 && row + stride < in.rows) stage(row + stride, (j + 1) & 1);

    float hi = 0.f;                            // absent values are 0
#pragma unroll
    for (int i = 0; i < PER; ++i) hi = max_nan(hi, fabsf(d[i]));
    const float t = bisect_threshold_by<PER, kWarp>(
        d, group_max<kWarp>(hi), width, in.k,
        [&](int i) { return runs.has(i / RUN); });
    epi(row, base, d, t, sg, runs);
  }
}

// The dynamic shared memory of a CTA for rows of `width`, and how many
// such CTAs an SM holds (0 when the attribute cannot be set).
template <bool FULL, typename S, typename Epilogue>
static int staged_occupancy(int width, int* smem) {
  auto kernel = staged_rows_kernel<FULL, S, Epilogue>;
  *smem = kStagedWarps * static_cast<int>(sizeof(uint64_t)) +
          kStagedWarps * staged_warp_bytes<S>(width);
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           *smem) != cudaSuccess)
    return 0;                                  // reported by cudaGetLastError
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                kStagedWarps * kWarp, *smem);
  return per_sm;
}

// One launch over a grid that fills the card once (the warps walk the
// rest); a failure is left for the caller's cudaGetLastError.
template <bool FULL, typename S, typename Epilogue>
static void launch_staged_walk(const StagedRows<S>& in, const Epilogue& epi,
                               cudaStream_t s) {
  int smem = 0;
  const int per_sm = staged_occupancy<FULL, S, Epilogue>(in.width, &smem);
  if (per_sm == 0 && cudaPeekAtLastError() != cudaSuccess) return;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = (in.rows + kStagedWarps - 1) / kStagedWarps;
  const long long fill =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = static_cast<unsigned>(need < fill ? need : fill);
  staged_rows_kernel<FULL, S, Epilogue>
      <<<grid, kStagedWarps * kWarp, smem, s>>>(in, epi);
}

template <typename S, typename Epilogue>
static void launch_staged(const StagedRows<S>& in, const Epilogue& epi,
                          cudaStream_t s) {
  if (in.width == kMaxWidth)
    launch_staged_walk<true>(in, epi, s);
  else
    launch_staged_walk<false>(in, epi, s);
}

}  // namespace efk
