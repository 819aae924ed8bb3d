// Fused EF21-SGDM client update for Hopper (sm_90a).
//
// Replaces src/repro/kernels/ef_update.py::ef21_sgdm_update (the Pallas TPU
// kernel _ef_kernel): per row of (rows, width), grad f32 and the EF state
// v, g f32 or bfloat16 (arithmetic in f32),
//     v' = (1-eta)*v + eta*grad
//     c  = where(|v'-g| >= t, v'-g, 0)     t: 26-step bisection (bisect.cuh)
//     g' = g + c
// and returns (v', g', c), each in the state's type (c has g's dtype, as in
// the reference; bf16 stores round to nearest even). The carrier folds the
// clients into rows, so one launch covers one parameter leaf for all
// clients.
//
// Bound: memory. Each element is read three times (grad, v, g) and written
// three times (v', g', c): 24 bytes per element with f32 state, 14 with
// bf16 state, and a few hundred integer and float operations per row, far
// below the card's compute rate.
//
// Design. Rows up to 1024 wide whose width is a multiple of 8, from bases
// on 16-byte boundaries (every carrier row of a block up to 1024), take the staged row walk of staged.cuh,
// the one K3 runs: a warp walks rows over a grid that fills the card once,
// the next row's grad, v and g arrive in shared memory by cp.async.bulk
// while the row bisects, and each lane holds runs of 16 bytes, so every
// load and store is 16 bytes a lane. v' is stored as soon as it is known;
// the epilogue below reads g back from shared memory (double-buffered
// there) and stores c and g' = g + c as 16-byte runs. On the fused path's
// rows it reads about 85 % of its bound (PERF.md); shared memory sets its
// residency (12 warps an SM with f32 state, 20 with bf16).
// Rows of any other width up to 1024 keep the strided kernel below: one
// warp a row with the row in registers (up to 32 values a lane), 4-byte
// loads consecutive across the warp. Rows wider than 1024 (any wider
// Block-TopK block) take the wide route of wide.cuh: one CTA a row, d and g
// kept in shared memory (rows up to 28,672 values) or recomputed from the
// unchanged inputs each pass (wider rows), with UpdateWideEpilogue below.
// All three stop the bisection early (bisect.cuh) and make the same
// roundings, so all are bit-identical to
// kernels/ref.py::ef21_sgdm_update_plain.
#include "wide.cuh"

namespace efk {

template <int PER, typename S>
__global__ void __launch_bounds__(kRowsPerBlock * kWarp)
ef21_sgdm_update_kernel(const float* grad, const S* v, const S* g, S* v_out,
                        S* g_out, S* c_out, long long rows, int width,
                        float c1, float c2, int k) {
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
    const int j = i * kWarp + lane;
    if (j < width) {
      const float c = fabsf(d[i]) >= t ? d[i] : 0.f;
      c_out[base + j] = from_f32<S>(c);
      g_out[base + j] = from_f32<S>(__fadd_rn(gv[i], c));
    }
  }
}

template <int PER, typename S>
static void launch(const float* grad, const void* v, const void* g,
                   void* v_out, void* g_out, void* c_out, long long rows,
                   int width, float c1, float c2, int k, cudaStream_t s) {
  ef21_sgdm_update_kernel<PER, S><<<grid_for_rows(rows),
                                    kRowsPerBlock * kWarp, 0, s>>>(
      grad, static_cast<const S*>(v), static_cast<const S*>(g),
      static_cast<S*>(v_out), static_cast<S*>(g_out), static_cast<S*>(c_out),
      rows, width, c1, c2, k);
}

template <typename S>
static void launch_state(const float* grad, const void* v, const void* g,
                         void* v_out, void* g_out, void* c_out,
                         long long rows, int width, float c1, float c2, int k,
                         cudaStream_t s) {
#define EFK_UPDATE(PER) \
  launch<PER, S>(grad, v, g, v_out, g_out, c_out, rows, width, c1, c2, k, s)
  if (width <= 32) EFK_UPDATE(1);
  else if (width <= 64) EFK_UPDATE(2);
  else if (width <= 128) EFK_UPDATE(4);
  else if (width <= 256) EFK_UPDATE(8);
  else if (width <= 512) EFK_UPDATE(16);
  else EFK_UPDATE(32);
#undef EFK_UPDATE
}

// c = where(|d| >= t, d, 0) and g' = g + c (from the f32 c), both stored in
// the state's type as 16-byte runs
template <typename S>
struct UpdateEpilogue {
  S* g_out;
  S* c_out;

  template <typename R>
  __device__ __forceinline__ void operator()(
      long long, long long base, float (&d)[Runs<S>::kPer], float t,
      const S* sg, const R& runs) const {
    constexpr int RUN = Runs<S>::kRun, NRUN = Runs<S>::kNRun;
#pragma unroll
    for (int r = 0; r < NRUN; ++r) {
      const int e0 = runs.first(r);
      if (runs.has(r)) {
        float gg[RUN], c[RUN];
        load_run(sg + e0, gg);
#pragma unroll
        for (int e = 0; e < RUN; ++e) {
          c[e] = fabsf(d[r * RUN + e]) >= t ? d[r * RUN + e] : 0.f;
          gg[e] = __fadd_rn(gg[e], c[e]);
        }
        store_run(c_out + base + e0, c);
        store_run(g_out + base + e0, gg);
      }
    }
  }
};

template <typename S>
static void launch_staged_state(const float* grad, const void* v,
                                const void* g, void* v_out, void* g_out,
                                void* c_out, long long rows, int width,
                                float c1, float c2, int k, cudaStream_t s) {
  const StagedRows<S> in{grad, static_cast<const S*>(v),
                         static_cast<const S*>(g), static_cast<S*>(v_out),
                         rows, width, c1, c2, k};
  launch_staged(in, UpdateEpilogue<S>{static_cast<S*>(g_out),
                                      static_cast<S*>(c_out)}, s);
}

// The wide route's last pass: c and g' = g + c, element by element
template <typename S>
struct UpdateWideEpilogue {
  S* g_out;
  S* c_out;

  template <typename Row>
  __device__ __forceinline__ void operator()(long long, long long base,
                                             float t, const Row& r,
                                             CtaReduce&) const {
#pragma unroll 4
    for (int j = threadIdx.x; j < r.in.width; j += kWideThreads) {
      float d, gj;
      r.last(j, d, gj);
      const float c = fabsf(d) >= t ? d : 0.f;
      c_out[base + j] = from_f32<S>(c);
      g_out[base + j] = from_f32<S>(__fadd_rn(gj, c));
    }
  }
};

template <typename S>
static void launch_wide_state(const float* grad, const void* v,
                              const void* g, void* v_out, void* g_out,
                              void* c_out, long long rows, int width,
                              float c1, float c2, int k, cudaStream_t s) {
  const StagedRows<S> in{grad, static_cast<const S*>(v),
                         static_cast<const S*>(g), static_cast<S*>(v_out),
                         rows, width, c1, c2, k};
  launch_wide(in, UpdateWideEpilogue<S>{static_cast<S*>(g_out),
                                        static_cast<S*>(c_out)}, s);
}

}  // namespace efk

// Returns the cudaError_t of the launch (0 on success). v, g and the outputs
// are f32 (state_bf16 = 0) or bfloat16 (state_bf16 = 1); grad is f32.
// Outputs may alias the inputs of the same element (in-place EF state
// update). Rows up to 1024 wide of a multiple of 8 values with every base
// 16-byte aligned take the staged kernel, other rows up to 1024 the strided
// one, wider rows the wide route.
extern "C" int ef_launch_ef21_sgdm_update(
    const void* grad, const void* v, const void* g, void* v_out, void* g_out,
    void* c_out, long long rows, int width, float c1, float c2, int k,
    int state_bf16, void* stream) {
  using namespace efk;
  auto gr = static_cast<const float*>(grad);
  auto s = static_cast<cudaStream_t>(stream);
  const int wide = wide_layout(width, kEfWideBytes);
  if (rows <= 0 || width <= 0 || k < 1 || (wide && rows > 0x7fffffffLL))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[6] = {grad, v, g, v_out, g_out, c_out};
  const bool staged = !wide && staged_fits(width, ptrs, 6);
#define EFK_UPDATE_STATE(S)                                                  \
  (wide ? launch_wide_state<S>(gr, v, g, v_out, g_out, c_out, rows, width,  \
                               c1, c2, k, s)                                \
   : staged ? launch_staged_state<S>(gr, v, g, v_out, g_out, c_out, rows,   \
                                     width, c1, c2, k, s)                   \
            : launch_state<S>(gr, v, g, v_out, g_out, c_out, rows, width,   \
                              c1, c2, k, s))
  if (state_bf16) EFK_UPDATE_STATE(__nv_bfloat16);
  else EFK_UPDATE_STATE(float);
#undef EFK_UPDATE_STATE
  return static_cast<int>(cudaGetLastError());
}

// The layout K2 and K3 run rows of `width` from these bases on (the
// launchers' own rule): 0 the strided kernel, 1 the staged one, 2 the wide
// route with the row in shared memory, 3 the wide route recomputing the
// row from device memory each pass.
extern "C" int ef_rows_layout(const void* grad, const void* v, const void* g,
                              const void* v_out, const void* g_out,
                              const void* c_out, int width) {
  using namespace efk;
  const int wide = wide_layout(width, kEfWideBytes);
  if (wide) return 1 + wide;
  const void* ptrs[6] = {grad, v, g, v_out, g_out, c_out};
  return staged_fits(width, ptrs, 6) ? 1 : 0;
}

// The staged K2 launch's dynamic shared memory (bytes, into *smem) and
// resident CTAs an SM (returned) for rows of `width` (a multiple of 8).
extern "C" int ef_staged_update_occupancy(int width, int state_bf16,
                                          int* smem) {
  using namespace efk;
  if (width <= 0 || width > kMaxWidth || width % 8) return -1;
#define EFK_OCC(FULL, S) staged_occupancy<FULL, S, UpdateEpilogue<S>>(width, smem)
  if (state_bf16)
    return width == kMaxWidth ? EFK_OCC(true, __nv_bfloat16)
                              : EFK_OCC(false, __nv_bfloat16);
  return width == kMaxWidth ? EFK_OCC(true, float) : EFK_OCC(false, float);
#undef EFK_OCC
}
