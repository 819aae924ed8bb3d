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
// Bound, at the serving prefill's shape (B 8, S 1024, H 15, KV 5, hd 64):
// q, k, v and out are 41.9 MB in bf16 (0.0125 ms at 3.35 TB/s) and 83.9 MB
// in f32; the causal work is 4*B*H*hd*S(S+1)/2 = 16.1 GFLOP, 0.0163 ms on
// the bf16 tensor cores and 0.241 ms on the f32 CUDA cores (67 TFLOP/s).
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
// f32 inputs: the CUDA-core kernel (efk_flash below). Its products stay
// f32 on the CUDA cores, so f32 serving stays within 2e-5 (single TF32
// products would not). Bound: the causal work over the f32 rate, 0.241 ms
// at the prefill's shape. One FMA needs two f32 operands; an SM fetches 32
// of them a clock from shared memory (or by shuffle) and issues 128 FMAs,
// so a thread must reuse each operand it reads at least 4 times, and all
// four schedulers must have warps to issue. The design:
//   - one CTA per (64-query tile, kv head, batch row) covers the query
//     heads that share the kv head (up to 3; more heads take more CTAs):
//     each K and V tile is staged ONCE for all of them;
//   - K and V arrive by cp.async, 16 bytes a copy, into a 2-stage ring:
//     tile j+1 is copied while tile j computes, one barrier a tile; keys
//     past S are zero-filled. q is scaled by f32(hd^-0.5) as it is staged;
//   - a thread scores TR query rows against keys tx, tx+8, ..., tx+56 and
//     accumulates the same rows over dims 32i + 4tx..+3. At hd 64 with 3
//     heads a CTA (the prefill's shape) TR is 12: 128 threads, two CTAs an
//     SM (8 warps, 112 KB of shared memory and up to 255 registers each),
//     12 x 8 scores and 12 rows x 8 dims a thread, 20 operands for 96 FMAs
//     (4.8 an operand), Q.K^T reading one dim a step. Elsewhere TR is 8:
//     64 threads a head, 8 x 8 a thread, two dims a step, 16 operands for
//     64 FMAs (hd 128 fits one CTA an SM). K and Q are row-major, their
//     16-byte chunks XOR-swizzled by key % 8 and by row group % 8, so the 8
//     keys and the row groups a read spans fall in distinct banks. (A
//     d-major K would let Q.K^T read 4 keys at once, but a 16-byte copy
//     cannot transpose it, and the registers hold no wider operand.)
//   - the 8 threads of a query row are 8 lanes of one warp: the row's max
//     and sum are 3 shuffles each, and P never leaves the registers: P.V
//     takes key 8c+t's column of P from lane t by shuffle and V's row as
//     float4s;
//   - scores, m, l, P and the accumulator are f32 (P is not rounded); m
//     and l of row r live in lane r % 8 of the row's 8 alone;
//   - strictly-future kv tiles are skipped, and blockIdx.z counts the query
//     tiles down from the end, so the longest are dispatched first.
// What bounds it: even at 12 x 8 the shared-memory and shuffle traffic is
// within a fifth of the FMAs' issue rate, and ptxas spills a few dozen
// bytes at 255 registers; it runs at about 41 % of the FMA rate (PERF.md).
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

constexpr int kBQ = 64;          // query rows of a head in a CTA
constexpr int kBK = 64;          // keys a kv tile
constexpr int kTK = 8;           // keys a thread scores: tx, tx+8, ..., tx+56
constexpr int kLanes = kBK / kTK;            // threads sharing a query row: 8
constexpr int kMaxHeads = 3;     // query heads a CTA (see launch below)
constexpr float kNegInf = -1e30f;

// TR query rows a thread. 12 when a CTA holds 3 heads at hd 64: 128
// threads, two CTAs (8 warps) an SM with up to 255 registers a thread, 20
// operands for 96 FMAs; else 8 (64 threads a head; 12 does not divide
// fewer heads' rows, hd 128's accumulators leave no room for 12 rows, and
// at hd 32 it measured slower).
template <int HD, int TR>
struct Geo {
  // floats a Q.K^T load reads along d: one at 12 rows, whose registers
  // hold no second operand of each
  static constexpr int kCh = TR == 12 ? 1 : 2;
  static constexpr int kTile = kBK * HD;        // floats of a K or V tile
  static constexpr int kDims = HD / kLanes;     // output dims a thread
  static constexpr int kPieces = kTile / 4;     // 16-byte copies a tile
  static constexpr int kMaxThreads = kMaxHeads * kBQ / TR * kLanes;
  static constexpr int kOwn = (TR + kLanes - 1) / kLanes;   // rows a lane owns
  // two CTAs an SM fit up to hd 64 (shared memory; registers: 168 a thread
  // at 8 rows, 255 at 12); hd 128's 128 accumulators a thread take one
  static constexpr int kMinBlocks = HD <= 64 ? 2 : 1;
};

template <int HD>
constexpr int smem_bytes(int heads) {   // Q tiles, then the 2-stage K/V ring
  return static_cast<int>(sizeof(float)) * (heads * kBQ * HD + 2 * 2 * kBK * HD);
}

// Element (r, d) of a row-major tile of 16-byte chunks whose chunk index is
// XORed with `x` in 0..7 (rows of at least 8 chunks: hd >= 32).
template <int HD>
__device__ __forceinline__ int swz(int r, int d, int x) {
  return r * HD + ((((d >> 2) ^ x)) << 2) + (d & 3);
}

template <int N>
__device__ __forceinline__ void lds(const float* p, float (&x)[N]) {
  if constexpr (N == 1) {
    x[0] = *p;
  } else if constexpr (N == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x; x[1] = a.y;
  } else {
    const float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  }
}

// 16 bytes global -> shared, asynchronous; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(hop::smem_addr(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Thread (ty, tx) = (tid / 8, tid % 8) of a CTA covers CTA rows ty*TR ..
// ty*TR+TR-1 (row c is head slot c / 64, position q0 + c % 64; a thread's
// rows may straddle two heads) with keys tx + 8c of each kv tile for
// Q.K^T and dims 32i + 4tx .. +3 for P.V; the 8 threads of a row are 8
// consecutive lanes of one warp.
template <int HD, int TR>
__global__ void __launch_bounds__(Geo<HD, TR>::kMaxThreads,
                                  Geo<HD, TR>::kMinBlocks)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int S, int H, int KV, int hpc, float scale,
                       int causal) {
  using Gm = Geo<HD, TR>;
  constexpr int kDims = Gm::kDims, kCh = Gm::kCh;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                             // hpc*64 rows x HD, swizzled
  float* ring = qs + hpc * kBQ * HD;            // stage s: K, then V

  const int G = H / KV;
  const int chunks = (G + hpc - 1) / hpc;
  const int kvh = blockIdx.x / chunks;
  const int h0 = kvh * G + (blockIdx.x % chunks) * hpc;   // first query head
  const int nh = min(hpc, (kvh + 1) * G - h0);            // heads of this CTA
  const int b = blockIdx.y;
  const int nq = (S + kBQ - 1) / kBQ;
  const int qt = nq - 1 - static_cast<int>(blockIdx.z);
  const int q0 = qt * kBQ;
  const int nk = (S + kBK - 1) / kBK;
  const int last = causal ? min(qt, nk - 1) : nk - 1;
  const int nthreads = hpc * kBQ / TR * kLanes;
  const int tid = threadIdx.x, lane = tid % 32;
  const int ty = tid / kLanes, tx = tid % kLanes;
  const int grp = lane & ~(kLanes - 1);         // lane 0 of the row's 8
  // a warp whose first row is in an unused head slot has only such rows
  const bool idle = (tid / 32) * (32 / kLanes) * TR / kBQ >= nh;
  const long long seq0 = static_cast<long long>(b) * S;

  // K and V tile j into stage j % 2: 16-byte copies, K's chunks swizzled by
  // key % 8, keys past S zero-filled
  auto issue = [&](int j) {
    float* ks = ring + (j & 1) * 2 * Gm::kTile;
    float* vs = ks + Gm::kTile;
    for (int i = tid; i < Gm::kPieces; i += nthreads) {
      const int key = i / (HD / 4), d = (i % (HD / 4)) * 4;
      const int s = j * kBK + key;
      const bool in = s < S;
      const long long off =
          in ? ((seq0 + s) * KV + kvh) * HD + d : 0;
      cp_async16(ks + swz<HD>(key, d, key & 7), k + off, in ? 16 : 0);
      cp_async16(vs + key * HD + d, v + off, in ? 16 : 0);
    }
    cp_async_commit();
  };
  issue(0);

  // the CTA's Q tiles, scaled by f32(hd^-0.5), chunks swizzled by the row
  // group (row / TR) % 8; rows past S and heads past nh are zeros
  for (int i = tid; i < hpc * kBQ * HD / 4; i += nthreads) {
    const int row = i / (HD / 4), d = (i % (HD / 4)) * 4;
    const int gg = row / kBQ, s = q0 + row % kBQ;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gg < nh && s < S) {
      x = *reinterpret_cast<const float4*>(
          q + ((seq0 + s) * H + h0 + gg) * HD + d);
      x = make_float4(__fmul_rn(x.x, scale), __fmul_rn(x.y, scale),
                      __fmul_rn(x.z, scale), __fmul_rn(x.w, scale));
    }
    *reinterpret_cast<float4*>(qs + swz<HD>(row, d, (row / TR) & 7)) = x;
  }

  // m and l of rows tx and tx + 8 of the thread's TR live in this lane
  // alone (the row's other lanes read them by shuffle)
  float m_own[Gm::kOwn], l_own[Gm::kOwn], acc[TR][kDims];
#pragma unroll
  for (int o = 0; o < Gm::kOwn; ++o) {
    m_own[o] = kNegInf;
    l_own[o] = 0.f;
  }
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int e = 0; e < kDims; ++e) acc[r][e] = 0.f;
  const float* qrow = qs + ty * TR * HD;        // the thread's TR rows

  for (int j = 0; j <= last; ++j) {
    cp_async_wait_all();
    __syncthreads();   // tile j (and Q) in place; tile j-1's stage is free
    if (j < last) issue(j + 1);
    if (idle) continue;                         // uniform across the warp
    const float* ks = ring + (j & 1) * 2 * Gm::kTile;
    const float* vs = ks + Gm::kTile;
    const int k0 = j * kBK;

    // S = Q.K^T: TR x 8 a thread, kCh dims a step from each of TR Q rows
    // and 8 K rows
    float sc[TR][kTK];
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int c = 0; c < kTK; ++c) sc[r][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; d += kCh) {
      float kf[kTK][kCh];
#pragma unroll
      for (int c = 0; c < kTK; ++c)
        lds<kCh>(ks + swz<HD>(c * kLanes + tx, d, tx), kf[c]);
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        float qf[kCh];
        lds<kCh>(qrow + swz<HD>(r, d, ty & 7), qf);
#pragma unroll
        for (int c = 0; c < kTK; ++c)
#pragma unroll
          for (int e = 0; e < kCh; ++e)
            sc[r][c] = fmaf(qf[e], kf[c][e], sc[r][c]);
      }
    }

    // online softmax; only the diagonal tile and a ragged last tile hold
    // masked keys
    const bool masked = (causal && j == qt) || k0 + kBK > S;
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const int row = q0 + (ty * TR + r) % kBQ;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kTK; ++c) {
        const int key = k0 + c * kLanes + tx;
        if (masked && (key >= S || (causal && key > row))) sc[r][c] = kNegInf;
        mx = fmaxf(mx, sc[r][c]);
      }
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old =
          __shfl_sync(0xffffffffu, m_own[r / kLanes], grp | (r % kLanes));
      const float m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kTK; ++c) {
        sc[r][c] = expf(sc[r][c] - m_new);
        sum = __fadd_rn(sum, sc[r][c]);
      }
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1)
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
      if (tx == r % kLanes) {
        l_own[r / kLanes] = alpha * l_own[r / kLanes] + sum;
        m_own[r / kLanes] = m_new;
      }
#pragma unroll
      for (int e = 0; e < kDims; ++e) acc[r][e] *= alpha;
    }

    // O += P.V, keys in order: P stays in registers; key 8c + t's column
    // of P comes from lane t of the row's 8 by shuffle, V's row as float4s
#pragma unroll
    for (int c = 0; c < kTK; ++c) {
#pragma unroll 2
      for (int t = 0; t < kLanes; ++t) {
        float p[TR], vv[kDims];
#pragma unroll
        for (int r = 0; r < TR; ++r)
          p[r] = __shfl_sync(0xffffffffu, sc[r][c], grp | t);
        const float* vrow = vs + (c * kLanes + t) * HD + tx * 4;
#pragma unroll
        for (int i = 0; i < kDims / 4; ++i) {
          float x[4];
          lds<4>(vrow + 32 * i, x);
#pragma unroll
          for (int e = 0; e < 4; ++e) vv[4 * i + e] = x[e];
        }
#pragma unroll
        for (int r = 0; r < TR; ++r)
#pragma unroll
          for (int e = 0; e < kDims; ++e)
            acc[r][e] = fmaf(p[r], vv[e], acc[r][e]);
      }
    }
  }

  float l[TR];
#pragma unroll
  for (int r = 0; r < TR; ++r)
    l[r] = __shfl_sync(0xffffffffu, l_own[r / kLanes], grp | (r % kLanes));
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    const int c = ty * TR + r;                  // the CTA row
    const int row = q0 + c % kBQ;
    if (c / kBQ >= nh || row >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    float* o = out + ((seq0 + row) * H + h0 + c / kBQ) * HD + tx * 4;
#pragma unroll
    for (int i = 0; i < kDims / 4; ++i)
      *reinterpret_cast<float4*>(o + 32 * i) = make_float4(
          __fdiv_rn(acc[r][4 * i], denom), __fdiv_rn(acc[r][4 * i + 1], denom),
          __fdiv_rn(acc[r][4 * i + 2], denom),
          __fdiv_rn(acc[r][4 * i + 3], denom));
  }
}

// query heads a CTA for G that share a kv head: as few CTAs as kMaxHeads
// allows, the heads spread evenly over them
inline int heads_per_cta(int G) {
  const int chunks = (G + kMaxHeads - 1) / kMaxHeads;
  return (G + chunks - 1) / chunks;
}

// above 48 KB a CTA must opt in to dynamic shared memory
template <int HD, int TR>
static cudaError_t opt_in() {
  return cudaFuncSetAttribute(flash_attention_kernel<HD, TR>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes<HD>(kMaxHeads));
}

// The launch of G query heads a kv head at head dim HD, rows a thread TR
// chosen by the shape: 12 for 3 heads a CTA at hd 64, else 8. `run` gets
// the kernel, its opt-in's error, the heads a CTA and the threads.
template <int HD, typename Run>
static int with_geometry(int G, Run run) {
  const int hpc = heads_per_cta(G);
  if constexpr (HD == 64) {
    if (hpc == kMaxHeads)
      return run(flash_attention_kernel<HD, 12>, opt_in<HD, 12>(), hpc,
                 hpc * kBQ / 12 * kLanes);
  }
  return run(flash_attention_kernel<HD, 8>, opt_in<HD, 8>(), hpc,
             hpc * kBQ / 8 * kLanes);
}

template <int HD>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int B, int S, int H, int KV, float scale, int causal,
                  cudaStream_t stream) {
  const void* ptrs[4] = {q, k, v, out};
  for (const void* p : ptrs)        // 16-byte copies and stores
    if (reinterpret_cast<uintptr_t>(p) % 16)
      return static_cast<int>(cudaErrorMisalignedAddress);
  if ((S + kBQ - 1) / kBQ > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / KV;
  return with_geometry<HD>(G, [&](auto kernel, cudaError_t err, int hpc,
                                  int threads) {
    if (err != cudaSuccess) return static_cast<int>(err);
    // the query tile is the slowest grid dimension, counted down from the
    // end: the tiles with the most causal work are dispatched first
    const dim3 grid(KV * ((G + hpc - 1) / hpc), B, (S + kBQ - 1) / kBQ);
    kernel<<<grid, threads, smem_bytes<HD>(hpc), stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), S, H, KV, hpc,
        scale, causal);
    return static_cast<int>(cudaGetLastError());
  });
}

static int launch_hd(const void* q, const void* k, const void* v, void* out,
                     int B, int S, int H, int KV, int hd, float scale,
                     int causal, cudaStream_t s) {
  switch (hd) {
    case 32: return launch<32>(q, k, v, out, B, S, H, KV, scale, causal, s);
    case 64: return launch<64>(q, k, v, out, B, S, H, KV, scale, causal, s);
    case 128: return launch<128>(q, k, v, out, B, S, H, KV, scale, causal, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int HD>
static int occupancy(int G, int* smem, int* rows) {
  return with_geometry<HD>(G, [&](auto kernel, cudaError_t err, int hpc,
                                  int threads) {
    *smem = smem_bytes<HD>(hpc);
    *rows = hpc * kBQ * kLanes / threads;
    int per_sm = 0;
    if (err != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                      *smem) != cudaSuccess)
      return -1;
    return per_sm;
  });
}

}  // namespace efk_flash

// The f32 route's launch at head dim hd with G query heads a kv head: its
// dynamic shared memory (bytes, into *smem), query rows a thread (*rows)
// and resident CTAs an SM (returned).
extern "C" int ef_flash_f32_occupancy(int hd, int G, int* smem, int* rows) {
  if (G < 1) return -1;
  switch (hd) {
    case 32: return efk_flash::occupancy<32>(G, smem, rows);
    case 64: return efk_flash::occupancy<64>(G, smem, rows);
    case 128: return efk_flash::occupancy<128>(G, smem, rows);
    default: return -1;
  }
}

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
    return efk_flash::launch_hd(q, k, v, out, B, S, H, KV, hd, scale, causal,
                                s);
  using namespace efk_flash_tc;
  switch (hd) {
    case 32: return launch<32>(q, k, v, out, B, S, H, KV, scale, causal, s);
    case 64: return launch<64>(q, k, v, out, B, S, H, KV, scale, causal, s);
    case 128: return launch<128>(q, k, v, out, B, S, H, KV, scale, causal, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
