// Causal flash-attention forward for Hopper (sm_90a), K7: two kernels, one
// a dtype.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (the Pallas
// TPU kernel _flash_kernel). For each batch row b, query head h and query
// position i, with m_i and l_i the online softmax's running max and sum:
//     s_ij  = q_i . k_j * f32(hd^-0.5)           j <= i when causal
//     out_i = (sum_j exp(s_ij - m_i) * v_j) / max(l_i, 1e-30)
// GQA in place: q is (B,S,H,hd), k and v (B,S,KV,hd), and query head h
// reads kv head h / (H/KV) (jnp.repeat(k, H/KV, axis=2) followed by the TPU
// kernel, with no expanded copy). Any S: a ragged last tile's query rows
// past S are not written and its keys past S are masked (the TPU kernel
// asserts S % block == 0). Head dims 32, 64 and 128.
//
// Bound, at the serving prefill's shape (B 8, S 1024, H 15, KV 5, hd 64,
// bf16): q, k, v and out are 41.9 MB, 0.0125 ms at 3.35 TB/s; the causal
// work is 4*B*H*hd*S(S+1)/2 = 16.1 GFLOP, 0.0163 ms on the bf16 tensor cores
// and 0.241 ms on the f32 CUDA cores.
//
// bf16 inputs: the tensor-core kernel (efk_flash_tc below).
//   - One CTA per (64-query tile, kv head, batch row) covers the query heads
//     that share the kv head: one consumer warpgroup per query head (up to
//     3 at hd <= 64 and 2 at hd 128, as many as the register file holds
//     with a score fragment, two P fragments and the output fragment a
//     thread; more heads take more CTAs), and one producer warp. The producer stages
//     each K and V tile ONCE for all of the CTA's heads with TMA
//     (cp.async.bulk.tensor, 4-D tensor maps over (hd, heads, S, B), 128 B
//     swizzle at hd >= 64, 64 B at hd 32) into a ring of 4 stages, each
//     with a "full" mbarrier (TMA bytes) and an "empty" one (a release by
//     every consumer warp); it loads the CTA's Q tiles first. Rows past S
//     arrive as zeros: the S dimension of the map ends each batch row, so
//     no tile reads into the next one.
//   - S = Q.K^T is wgmma m64n64k16 with both operands in shared memory
//     (K-major descriptors on the swizzled tiles) and f32 accumulators.
//     Tile j+1's S is waited for, then tile j's P.V issued; the softmax
//     of tile j+1 runs (into a second P fragment) while P.V runs on the
//     tensor cores, and O is rescaled once P.V is done, so no register of
//     a product in flight is read or written.
//     S is scaled in f32 (__fmul_rn), masked (only on the diagonal tile
//     and a ragged last tile: keys past S, and keys past the row when
//     causal) and the online softmax runs on the accumulator registers, a
//     row's max and sum reduced over the quad of lanes holding it; its
//     exponentials are exp2f((s - m) * f32(log2 e)), a relative 1e-6 from
//     expf.
//   - O += P.V is wgmma m64n{hd}k16 with P as the A operand from registers
//     (the f32 fragment rounded to bf16, two values a register) and V read
//     MN-major from shared memory ("trans-b"). P is rounded to bf16 for this
//     product, as the reference's chunked attention rounds it
//     (models/layers.py), while l is summed from the f32 P before rounding.
//     kernels/ref.py::flash_attention_plain(round_p=True) makes the same
//     roundings with a materialised softmax.
//   - Strictly-future kv tiles are skipped; blockIdx.z, the slowest grid
//     dimension, counts the query tiles down from the end, so the tiles
//     with the most work are dispatched first, across all heads and rows.
//   - The epilogue divides by max(l, 1e-30) with __fdiv_rn and stores bf16
//     rounded to nearest even, straight from the accumulator fragment.
// The tensor maps are made on the host by cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint(ByVersion): the library links no -lcuda.
//
// f32 inputs: the CUDA-core kernel (efk_flash below), so f32 serving stays
// within 2e-5 (TF32 products would not be):
//   - one CTA of 256 threads per (query tile of 64 rows, head, batch row);
//     q is scaled by f32(hd^-0.5) before the product, and the scores, m, l,
//     P and the accumulator are all f32 (P is not rounded);
//   - the scaled Q tile, and each 64-key K and V tile in turn, are staged in
//     shared memory as f32; thread (ty, tx) = (tid / 16, tid % 16) owns
//     query rows 4ty..4ty+3 and keys tx, tx+16, tx+32, tx+48 of a tile (a
//     4x4 register tile); a row's 16 threads reduce its max and sum with
//     shuffles; P goes through shared memory to the P.V layout; rows are
//     padded so no two lanes of a warp read one bank. It is bound by
//     shared-memory loads, and 0.241 ms is its own floor.
//
// Rounding, both kernels: expf (the f32 kernel) or exp2f (the bf16 one),
// never __expf, no --use_fast_math, the final normalisation an IEEE
// division (__fdiv_rn), the output rounded to nearest even. nvcc may
// contract the rescales' multiply-adds into FMAs; that, like the order of
// the sums, stays inside the tolerance the kernels are held to
// against kernels/ref.py::flash_attention_plain (2e-5 in f32, 2e-2 in bf16,
// atol and rtol). Masked scores are -1e30 as in the TPU kernel: every row
// meets a real key (key 0) in its first tile, after which exp of a masked
// score underflows to exactly 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace efk_flash {

constexpr int kBQ = 64;                         // query rows a CTA
constexpr int kBK = 64;                         // keys a kv tile
constexpr int kThreads = 256;
constexpr int kLanesPerRow = 16;                // threads sharing a query row
constexpr int kRows = kBQ * kLanesPerRow / kThreads;   // rows a thread: 4
constexpr int kKeys = kBK / kLanesPerRow;       // keys a thread scores: 4
constexpr int kPStride = kBK + 4;               // rows 4 apart: 16 banks apart
constexpr float kNegInf = -1e30f;

// the CUDA-core kernel is instantiated for f32 only (bf16 takes the
// tensor cores)
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

// over the 16 lanes of a half-warp (xor offsets below 16 stay inside it)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = kLanesPerRow / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = kLanesPerRow / 2; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int HD>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(float)) *
         (kBQ * (HD + 1) + kBK * (HD + 1) + kBK * HD + kBQ * kPStride);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S,
                       int H, int KV, float scale, int causal) {
  constexpr int kDims = HD / kLanesPerRow;      // output dims a thread
  extern __shared__ float smem[];
  float* qs = smem;                             // kBQ x (HD+1)
  float* ks = qs + kBQ * (HD + 1);              // kBK x (HD+1)
  float* vs = ks + kBK * (HD + 1);              // kBK x HD
  float* ps = vs + kBK * HD;                    // kBQ x kPStride

  const int nq = (S + kBQ - 1) / kBQ;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int ty = tid / kLanesPerRow, tx = tid % kLanesPerRow;
  const int q0 = qt * kBQ;
  const long long seq0 = static_cast<long long>(b) * S;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, s = q0 + r;
    qs[r * (HD + 1) + d] =
        s < S ? __fmul_rn(to_f32(q[((seq0 + s) * H + h) * HD + d]), scale)
              : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kDims];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kDims; ++e) acc[r][e] = 0.f;
  }

  const int nk = (S + kBK - 1) / kBK;
  const int last = causal ? min(qt, nk - 1) : nk - 1;
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // Q stored; the last tile's P.V done with vs and ps
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int j = i / HD, d = i % HD, s = k0 + j;
      const bool in = s < S;
      const long long off = ((seq0 + s) * KV + kvh) * HD + d;
      ks[j * (HD + 1) + d] = in ? to_f32(k[off]) : 0.f;
      vs[j * HD + d] = in ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    float sc[kRows][kKeys];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kKeys; ++c) sc[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[kRows], kv[kKeys];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        qv[r] = qs[(ty * kRows + r) * (HD + 1) + d];
#pragma unroll
      for (int c = 0; c < kKeys; ++c)
        kv[c] = ks[(tx + c * kLanesPerRow) * (HD + 1) + d];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kKeys; ++c) sc[r][c] = fmaf(qv[r], kv[c], sc[r][c]);
    }

    // only the diagonal tile and a ragged last tile hold masked keys
    const bool masked = (causal && kt == qt) || k0 + kBK > S;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = q0 + ty * kRows + r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kKeys; ++c) {
        const int key = k0 + tx + c * kLanesPerRow;
        if (masked && (key >= S || (causal && key > row))) sc[r][c] = kNegInf;
        mx = fmaxf(mx, sc[r][c]);
      }
      const float m_new = fmaxf(m[r], row_max(mx));
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kKeys; ++c) {
        const float p = expf(sc[r][c] - m_new);
        ps[(ty * kRows + r) * kPStride + tx + c * kLanesPerRow] = p;
        sum = __fadd_rn(sum, p);
      }
      l[r] = alpha * l[r] + row_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < kDims; ++e) acc[r][e] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) pv[r] = ps[(ty * kRows + r) * kPStride + j];
#pragma unroll
      for (int e = 0; e < kDims; ++e) {
        const float vv = vs[j * HD + tx + e * kLanesPerRow];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r][e] = fmaf(pv[r], vv, acc[r][e]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + ty * kRows + r;
    if (row >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* o = out + ((seq0 + row) * H + h) * HD;
#pragma unroll
    for (int e = 0; e < kDims; ++e)
      o[tx + e * kLanesPerRow] = from_f32<T>(__fdiv_rn(acc[r][e], denom));
  }
}

template <typename T, int HD>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int B, int S, int H, int KV, float scale, int causal,
                  cudaStream_t stream) {
  constexpr int smem = smem_bytes<HD>();
  auto kernel = flash_attention_kernel<T, HD>;
  // above 48 KB a CTA must opt in to dynamic shared memory
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, KV, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_hd(const void* q, const void* k, const void* v, void* out,
                     int B, int S, int H, int KV, int hd, float scale,
                     int causal, cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, out, B, S, H, KV, scale, causal, s);
    case 64: return launch<T, 64>(q, k, v, out, B, S, H, KV, scale, causal, s);
    case 128: return launch<T, 128>(q, k, v, out, B, S, H, KV, scale, causal, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace efk_flash

namespace efk_flash_tc {

constexpr int kRows = 64;        // query rows of a warpgroup (wgmma's M)
constexpr int kKeys = 64;        // keys of a kv tile
constexpr int kStages = 4;       // K/V ring
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Geo {
  static constexpr int kCols = HD < 64 ? HD : 64;    // columns a swizzle block
  static constexpr int kBlocks = HD / kCols;         // column blocks a tile
  static constexpr int kRowBytes = kCols * 2;        // 64 or 128
  static constexpr uint32_t kSwizzle = kRowBytes == 128 ? 1 : 2;  // 128B/64B
  static constexpr int kBlockBytes = 64 * kRowBytes;
  static constexpr int kTileBytes = kBlocks * kBlockBytes;  // 64 rows x HD
  static constexpr int kStepsPerBlock = kCols / 16;  // k-steps of Q.K^T
  static constexpr int kMaxHeads = HD <= 64 ? 3 : 2; // consumer warpgroups
  static constexpr int kMaxThreads = kMaxHeads * 128 + 32;
  // 8 rows of a swizzle atom: the stride between 8-row groups
  static constexpr uint32_t kSBO = (8 * kRowBytes) >> 4;
  // MN-major V: the stride between column blocks
  static constexpr uint32_t kLBO = kBlockBytes >> 4;
};

template <int HD>
constexpr int smem_bytes(int heads) {
  // 1 KB of slack to align the swizzled tiles, then Q tiles, the K/V ring
  // and the mbarriers
  return 1024 + (heads + 2 * kStages) * Geo<HD>::kTileBytes + 64;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<32>(float (&o)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  hop::wgmma_rs_n32(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  hop::wgmma_rs_n64(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  hop::wgmma_rs_n128(o, a, db);
}

// Thread t of a consumer warpgroup holds, of each 64-row fragment, rows
// r0 = 16*(warp % 4) + lane/4 and r0 + 8, and in every 8-column chunk c the
// column pair 8c + 2*(lane % 4) + {0, 1}: element 4c + e is at row
// r0 + 8*(e >> 1), column 8c + 2*(lane % 4) + (e & 1).
template <int HD>
__global__ void __launch_bounds__(Geo<HD>::kMaxThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ out, int S, int H, int KV,
                int hpc, float scale, int causal) {
  using Gm = Geo<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (hop::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* sq = smem;                                  // hpc Q tiles
  uint8_t* skv = sq + hpc * Gm::kTileBytes;            // stage s: K, then V
  uint64_t* full = reinterpret_cast<uint64_t*>(
      skv + 2 * kStages * Gm::kTileBytes);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int G = H / KV;
  const int chunks = (G + hpc - 1) / hpc;
  const int kvh = blockIdx.x / chunks;
  const int h0 = kvh * G + (blockIdx.x % chunks) * hpc;   // first query head
  const int nh = min(hpc, (kvh + 1) * G - h0);            // heads of this CTA
  const int b = blockIdx.y;
  const int nq = (S + kRows - 1) / kRows;
  const int qt = nq - 1 - static_cast<int>(blockIdx.z);
  const int q0 = qt * kRows;
  const int nk = (S + kKeys - 1) / kKeys;
  const int last = causal ? min(qt, nk - 1) : nk - 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 4 * nh);       // every consumer warp releases
    }
    hop::mbar_init(qbar, 1);
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * hpc) {                       // the producer warp
    if (lane == 0) {
      hop::mbar_arrive_expect_tx(qbar, nh * Gm::kTileBytes);
      for (int g = 0; g < nh; ++g)
        for (int cb = 0; cb < Gm::kBlocks; ++cb)
          hop::tma_load_4d(sq + g * Gm::kTileBytes + cb * Gm::kBlockBytes, &tq,
                           qbar, cb * Gm::kCols, h0 + g, q0, b);
      for (int j = 0; j <= last; ++j) {
        const int s = j % kStages;
        if (j >= kStages) hop::mbar_wait(&empty[s], ((j / kStages) - 1) & 1);
        hop::mbar_arrive_expect_tx(&full[s], 2 * Gm::kTileBytes);
        uint8_t* ks = skv + 2 * s * Gm::kTileBytes;
        for (int cb = 0; cb < Gm::kBlocks; ++cb) {
          hop::tma_load_4d(ks + cb * Gm::kBlockBytes, &tk, &full[s],
                           cb * Gm::kCols, kvh, j * kKeys, b);
          hop::tma_load_4d(ks + Gm::kTileBytes + cb * Gm::kBlockBytes, &tv,
                           &full[s], cb * Gm::kCols, kvh, j * kKeys, b);
        }
      }
    }
    return;
  }
  const int g = warp / 4;                      // this warpgroup's query head
  if (g >= nh) return;
  const int r0 = (warp % 4) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const uint32_t q_base = hop::smem_addr(sq + g * Gm::kTileBytes);
  const uint32_t kv_base = hop::smem_addr(skv);

  // S = Q.K^T of kv tile j into `sc`, issued and committed, not waited
  float o[HD / 2], sc[32];
  auto issue_scores = [&](int j) {
    const int s = j % kStages;
    hop::mbar_wait(&full[s], (j / kStages) & 1);
    const uint32_t k_base = kv_base + 2 * s * Gm::kTileBytes;
    hop::fence_regs(sc);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk / Gm::kStepsPerBlock) * Gm::kBlockBytes +
                           (kk % Gm::kStepsPerBlock) * 32;
      hop::wgmma_ss_n64(
          sc, hop::gmma_desc(q_base + off, 1, Gm::kSBO, Gm::kSwizzle),
          hop::gmma_desc(k_base + off, 1, Gm::kSBO, Gm::kSwizzle), kk > 0);
    }
    hop::wgmma_commit();
  };

  // The online softmax of kv tile j on its complete scores `sc`: updates
  // m and l, leaves P (bf16) as the A fragments of the four 16-key steps
  // (chunks 2kk and 2kk+1) in `pa`, and returns the rescale of O per row.
  // It touches neither O nor the P fragments of a P.V in flight.
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  auto softmax = [&](int j, uint32_t (&pa)[4][4], float (&alpha)[2]) {
    hop::fence_regs(sc);
    const int k0 = j * kKeys;
    const bool masked = (causal && j == qt) || k0 + kKeys > S;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      float x = __fmul_rn(sc[i], scale);
      if (masked) {
        const int key = k0 + 8 * (i >> 2) + cq + (i & 1);
        const int row = q0 + r0 + 8 * r;
        if (key >= S || (causal && key > row)) x = kNegInf;
      }
      sc[i] = x;
      mx[r] = fmaxf(mx[r], x);
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = exp2f(__fmul_rn(m[r] - m_new, kLog2e));
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      sc[i] = exp2f(__fmul_rn(sc[i] - m[r], kLog2e));
      sum[r] = __fadd_rn(sum[r], sc[i]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + quad_sum(sum[r]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  };

  // Tile j, whose P is `cur`: the next tile's S, waited for; then this
  // tile's O += P.V, during which the next softmax runs (into `nxt`);
  // then wait for P.V, release the stage and rescale O. No register of a
  // product in flight is read or written.
  auto step = [&](uint32_t (&cur)[4][4], uint32_t (&nxt)[4][4], int j) {
    hop::fence_regs(o);
    if (j < last) {
      issue_scores(j + 1);
      hop::wgmma_wait<0>();
      hop::fence_regs(sc);
    }
    const int s = j % kStages;
    const uint32_t v_base = kv_base + (2 * s + 1) * Gm::kTileBytes;
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<HD>(o, cur[kk],
                   hop::gmma_desc(v_base + kk * 16 * Gm::kRowBytes, Gm::kLBO,
                                  Gm::kSBO, Gm::kSwizzle));
    hop::wgmma_commit();
    float alpha[2] = {1.f, 1.f};
    if (j < last) softmax(j + 1, nxt, alpha);
    hop::wgmma_wait<0>();
    hop::fence_regs(o);
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&empty[s]);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
  };

#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  uint32_t pa[4][4], pb[4][4];
  float alpha0[2];
  hop::mbar_wait(qbar, 0);
  issue_scores(0);
  hop::wgmma_wait<0>();
  softmax(0, pa, alpha0);                      // O is 0: no rescale
  for (int j = 0; j <= last; j += 2) {
    step(pa, pb, j);
    if (j + 1 <= last) step(pb, pa, j + 1);
  }

  const int h = h0 + g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    if (row >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow =
        out + ((static_cast<long long>(b) * S + row) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      const __nv_bfloat162 v2 = __floats2bfloat162_rn(
          __fdiv_rn(o[4 * c + 2 * r], denom),
          __fdiv_rn(o[4 * c + 2 * r + 1], denom));
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c + cq) = v2;
    }
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime
typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// (hd, heads, S, B) bf16, row-major and contiguous; a box is one column
// block of 64 rows of one head of one batch row
template <int HD>
static bool tensor_map(CUtensorMap* map, const void* base, int heads, int S,
                       int B) {
  using Gm = Geo<HD>;
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(HD),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(HD) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(Gm::kCols), 1, kRows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            Gm::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int B, int S, int H, int KV, float scale, int causal,
                  cudaStream_t stream) {
  using Gm = Geo<HD>;
  const void* ptrs[4] = {q, k, v, out};
  for (const void* p : ptrs)        // TMA needs 16-byte aligned bases
    if (reinterpret_cast<uintptr_t>(p) % 16)
      return static_cast<int>(cudaErrorMisalignedAddress);
  CUtensorMap tq, tk, tv;
  if (!tensor_map<HD>(&tq, q, H, S, B) || !tensor_map<HD>(&tk, k, KV, S, B) ||
      !tensor_map<HD>(&tv, v, KV, S, B))
    return static_cast<int>(cudaErrorInvalidValue);
  // the G query heads of a kv head in as few CTAs as the warpgroups allow
  const int G = H / KV;
  const int chunks0 = (G + Gm::kMaxHeads - 1) / Gm::kMaxHeads;
  const int hpc = (G + chunks0 - 1) / chunks0;
  const int chunks = (G + hpc - 1) / hpc;
  if ((S + kRows - 1) / kRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_tc_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<HD>(Gm::kMaxHeads));
  if (err != cudaSuccess) return static_cast<int>(err);
  // the query tile is the slowest grid dimension, counted down from the
  // end: the tiles with the most causal work are dispatched first
  const dim3 grid(KV * chunks, B, (S + kRows - 1) / kRows);
  kernel<<<grid, hpc * 128 + 32, smem_bytes<HD>(hpc), stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), S, H, KV, hpc, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace efk_flash_tc

// q (B,S,H,hd), k and v (B,S,KV,hd), out (B,S,H,hd), all contiguous and of
// one dtype: f32 (bf16 = 0, the CUDA-core kernel) or bf16 (bf16 = 1, the
// tensor-core kernel). scale is f32(hd^-0.5). Returns the cudaError_t of the
// launch (0 on success).
extern "C" int ef_launch_flash_attention(const void* q, const void* k,
                                         const void* v, void* out, int B,
                                         int S, int H, int KV, int hd,
                                         int bf16, int causal, float scale,
                                         void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H <= 0 || H % KV || B > 65535 ||
      H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (!bf16)
    return efk_flash::launch_hd<float>(q, k, v, out, B, S, H, KV, hd, scale,
                                       causal, s);
  using namespace efk_flash_tc;
  switch (hd) {
    case 32: return launch<32>(q, k, v, out, B, S, H, KV, scale, causal, s);
    case 64: return launch<64>(q, k, v, out, B, S, H, KV, scale, causal, s);
    case 128: return launch<128>(q, k, v, out, B, S, H, KV, scale, causal, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
