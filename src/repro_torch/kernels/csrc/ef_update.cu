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
// Design: one warp per row with the row in registers (width <= 1024, up to
// 32 values a lane), so the 26 counting passes cost no memory traffic and
// no block-wide barrier: each pass is a register compare and one warp
// reduction. Loads are 4 bytes a lane, consecutive across the warp. Making
// it fast (several rows a warp, 16-byte loads, cp.async/TMA staging) is
// later work.
#include "bisect.cuh"

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

}  // namespace efk

// Returns the cudaError_t of the launch (0 on success). v, g and the outputs
// are f32 (state_bf16 = 0) or bfloat16 (state_bf16 = 1); grad is f32.
// Outputs may alias the inputs of the same element (in-place EF state
// update).
extern "C" int ef_launch_ef21_sgdm_update(
    const void* grad, const void* v, const void* g, void* v_out, void* g_out,
    void* c_out, long long rows, int width, float c1, float c2, int k,
    int state_bf16, void* stream) {
  using namespace efk;
  auto gr = static_cast<const float*>(grad);
  auto s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || width <= 0 || width > kMaxWidth || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (state_bf16)
    launch_state<__nv_bfloat16>(gr, v, g, v_out, g_out, c_out, rows, width,
                                c1, c2, k, s);
  else
    launch_state<float>(gr, v, g, v_out, g_out, c_out, rows, width, c1, c2,
                        k, s);
  return static_cast<int>(cudaGetLastError());
}
