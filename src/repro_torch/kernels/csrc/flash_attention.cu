// Causal flash-attention forward for Hopper (sm_90a), K7.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (the Pallas
// TPU kernel _flash_kernel). For each batch row b, query head h and query
// position i:
//     q_i   = f32(q[b,i,h]) * f32(hd^-0.5)
//     s_ij  = q_i . f32(k[b,j,h/G])              f32; j <= i when causal
//     out_i = (sum_j exp(s_ij - m_i) * f32(v[b,j,h/G])) / max(l_i, 1e-30)
// with m_i and l_i the online softmax's running max and running sum; the
// scores, m, l, P and the accumulator are all f32, and P is NOT rounded to
// v's dtype before P.V (models/layers.py::chunked_attention does round it).
// The output is in q's dtype.
//
// Where it departs from the TPU kernel:
//   - GQA in place: q is (B,S,H,hd), k and v are (B,S,KV,hd), and query head
//     h reads kv head h / (H/KV): the function of jnp.repeat(k, H/KV, axis=2)
//     followed by the TPU kernel, with no expanded copy.
//   - Any S: the last tile is ragged; its query rows past S are not written
//     and its keys past S are masked (the TPU kernel asserts S % block == 0).
//   - f32 or bf16 inputs; head dims 32, 64 and 128.
//
// Bound, at the serving prefill's shape (B 8, S 1024, H 15, KV 5, hd 64,
// bf16): q, k, v and out are 41.9 MB, 0.0125 ms at 3.35 TB/s; the causal
// work is 4*B*H*hd*S(S+1)/2 = 16.1 GFLOP, 0.0163 ms on the bf16 tensor cores
// and 0.241 ms on the f32 CUDA cores. This first version does its products
// in f32 on the CUDA cores, so 0.241 ms is its own floor.
//
// Design (a simple kernel that is right):
//   - one CTA of 256 threads per (query tile of 64 rows, head, batch row);
//     blockIdx.x counts the tiles down from the end of the sequence, so the
//     tiles with the most causal work start first;
//   - the scaled Q tile, and each 64-key K and V tile in turn, are staged in
//     shared memory as f32; a query tile visits kv tiles 0..its own index and
//     skips the strictly-future ones (when causal);
//   - thread (ty, tx) = (tid / 16, tid % 16) owns query rows 4ty..4ty+3: it
//     scores them against keys tx, tx+16, tx+32, tx+48 of the tile (a 4x4
//     register tile) and accumulates their output dims tx, tx+16, ...; the
//     16 threads of a row are one half-warp and reduce its max and sum with
//     shuffles;
//   - P goes through shared memory from the score layout to the P.V layout;
//   - shared-memory rows are padded (hd+1 floats for Q and K, 68 for P), so
//     no two lanes of a warp read different words of one bank.
// Tensor cores (mma.sync or wgmma), TMA staging and warp specialisation are
// for the redesign that makes it fast.
//
// Rounding: expf (not __expf), no --use_fast_math, the final normalisation
// an IEEE division (__fdiv_rn), the output rounded to nearest even
// (__float2bfloat16_rn for bf16). nvcc may contract the dot products' and
// the rescales' multiply-adds into FMAs; that, like the order of the sums,
// stays inside the tolerance the kernel is held to against
// kernels/ref.py::flash_attention_plain (2e-5 in f32, 2e-2 in bf16, atol
// and rtol). Masked scores are -1e30 as in the TPU kernel: every row meets a
// real key (key 0) in its first tile, after which exp of a masked score
// underflows to exactly 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace efk_flash {

constexpr int kBQ = 64;                         // query rows a CTA
constexpr int kBK = 64;                         // keys a kv tile
constexpr int kThreads = 256;
constexpr int kLanesPerRow = 16;                // threads sharing a query row
constexpr int kRows = kBQ * kLanesPerRow / kThreads;   // rows a thread: 4
constexpr int kKeys = kBK / kLanesPerRow;       // keys a thread scores: 4
constexpr int kPStride = kBK + 4;               // rows 4 apart: 16 banks apart
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

// q (B,S,H,hd), k and v (B,S,KV,hd), out (B,S,H,hd), all contiguous and of
// one dtype: f32 (bf16 = 0) or bf16 (bf16 = 1). scale is f32(hd^-0.5).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ef_launch_flash_attention(const void* q, const void* k,
                                         const void* v, void* out, int B,
                                         int S, int H, int KV, int hd,
                                         int bf16, int causal, float scale,
                                         void* stream) {
  using namespace efk_flash;
  if (B <= 0 || S <= 0 || KV <= 0 || H <= 0 || H % KV || B > 65535 ||
      H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_hd<__nv_bfloat16>(q, k, v, out, B, S, H, KV, hd,
                                         scale, causal, s)
              : launch_hd<float>(q, k, v, out, B, S, H, KV, hd, scale,
                                 causal, s);
}
