// Fused EF21-SGDM client update for Hopper (sm_90a).
//
// Replaces src/repro/kernels/ef_update.py::ef21_sgdm_update (the Pallas TPU
// kernel _ef_kernel): per row of (rows, width) f32,
//     v' = (1-eta)*v + eta*grad
//     c  = where(|v'-g| >= t, v'-g, 0)     t: 26-step bisection (bisect.cuh)
//     g' = g + c
// and returns (v', g', c). The carrier folds the clients into rows, so one
// launch covers one parameter leaf for all clients.
//
// Bound: memory. Each element is read three times (grad, v, g) and written
// three times (v', g', c): 24 bytes per element and a few hundred integer
// and float operations per row, far below the card's compute rate.
//
// Design: one warp per row with the row in registers (width <= 1024, up to
// 32 values a lane), so the 26 counting passes cost no memory traffic and
// no block-wide barrier: each pass is a register compare and one warp
// reduction. Loads are 4 bytes a lane, consecutive across the warp. Making
// it fast (several rows a warp, 16-byte loads, cp.async/TMA staging) is
// later work.
#include "bisect.cuh"

namespace efk {

template <int PER>
__global__ void __launch_bounds__(kRowsPerBlock * kWarp)
ef21_sgdm_update_kernel(const float* grad, const float* v, const float* g,
                        float* v_out, float* g_out, float* c_out,
                        long long rows, int width, float c1, float c2, int k) {
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
      c_out[base + j] = c;
      g_out[base + j] = __fadd_rn(gv[i], c);
    }
  }
}

template <int PER>
static void launch(const float* grad, const float* v, const float* g,
                   float* v_out, float* g_out, float* c_out, long long rows,
                   int width, float c1, float c2, int k, cudaStream_t s) {
  ef21_sgdm_update_kernel<PER><<<grid_for_rows(rows), kRowsPerBlock * kWarp,
                                 0, s>>>(grad, v, g, v_out, g_out, c_out, rows,
                                         width, c1, c2, k);
}

}  // namespace efk

// Returns the cudaError_t of the launch (0 on success). Outputs may alias
// the inputs of the same element (in-place EF state update).
extern "C" int ef_launch_ef21_sgdm_update(
    const void* grad, const void* v, const void* g, void* v_out, void* g_out,
    void* c_out, long long rows, int width, float c1, float c2, int k,
    void* stream) {
  using namespace efk;
  auto gr = static_cast<const float*>(grad);
  auto vv = static_cast<const float*>(v);
  auto gg = static_cast<const float*>(g);
  auto vo = static_cast<float*>(v_out);
  auto go = static_cast<float*>(g_out);
  auto co = static_cast<float*>(c_out);
  auto s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || width <= 0 || width > kMaxWidth || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (width <= 32) launch<1>(gr, vv, gg, vo, go, co, rows, width, c1, c2, k, s);
  else if (width <= 64) launch<2>(gr, vv, gg, vo, go, co, rows, width, c1, c2, k, s);
  else if (width <= 128) launch<4>(gr, vv, gg, vo, go, co, rows, width, c1, c2, k, s);
  else if (width <= 256) launch<8>(gr, vv, gg, vo, go, co, rows, width, c1, c2, k, s);
  else if (width <= 512) launch<16>(gr, vv, gg, vo, go, co, rows, width, c1, c2, k, s);
  else launch<32>(gr, vv, gg, vo, go, co, rows, width, c1, c2, k, s);
  return static_cast<int>(cudaGetLastError());
}
