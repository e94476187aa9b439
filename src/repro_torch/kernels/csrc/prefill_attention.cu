// One-query cached attention (GQA) for sm_90a.
//
// Replaces the TPU kernel
// src/repro/kernels/prefill_attention.py::prefill_attention_pallas, and
// computes nn/attention.py::attend_full step by step, in the rounding
// order of the reference:
//
//   qg     = q * scale              in q's type (scale already in q's type)
//   s[t]   = sum_d float(qg[d]) * float(k[t, d])           float32
//   s[t]   = -1e30 where mask[t] == 0
//   p[t]   = exp(s[t] - max s) / sum exp(s - max s)        float32
//   p[t]   = float(round_to_q_type(p[t]))
//   out[d] = round_to_q_type(sum_t p[t] * float(v[t, d]))  float32 sum
//
// q is (B, H, D), k and v (B, S, Hkv, D), mask (B, S) int32, all of one
// type (float32 or bfloat16); the G = H / Hkv query heads of KV head h are
// heads h*G .. h*G+G-1, as in the reference's grouped layout.
//
// Bound on this card: at the serving path's shape (B 4, H 16, Hkv 2,
// D 128, S 128, bfloat16) one call reads 256 KB of cache and does about
// 4 MFLOP, 0.17 us of bytes at 3.35 TB/s; any launch costs more than that,
// and the grid has only B x Hkv = 8 blocks.  So what bounds a call is the
// latency of each block's loads, and the design keeps every load
// independent and coalesced: one block per (KV head, batch row) with the
// group's G query heads; the scaled queries, the (G, S) score matrix and
// one tile of 64 cache slots (K for the scores, then V for the sum) in
// shared memory, each tile loaded by all 256 threads at once; one thread
// per (head, slot) score, summed over D in order; one warp per query head
// for the softmax; one thread per output element for the PV sum over the
// slots in order.  The tile's rows are padded by one float so the score
// threads, which read different rows, do not collide in one bank.  exp is
// expf (no fast-math), and products and sums are written as __fmaf_rn /
// __fadd_rn / __fdiv_rn so nvcc's --fmad choice cannot change the
// rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxGroup = 16;  // query heads per KV head
constexpr int kTileS = 64;     // cache slots staged at a time
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// round a float32 to T and back (identity for float32)
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(~0u, v, o));
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

// Stage slots t0 .. t0+n-1 of one KV head's cache rows as float32, row
// pitch `pitch`, all threads loading consecutive elements of each row.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int t0,
                                          int n, int d_dim, int pitch,
                                          size_t t_stride) {
  for (int i = threadIdx.x; i < n * d_dim; i += kThreads) {
    const int t = i / d_dim, d = i % d_dim;
    dst[t * pitch + d] = to_float(src[(t0 + t) * t_stride + d]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) prefill_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ mask, T* __restrict__ out, int h_dim, int hkv,
    int d_dim, int s_len, float scale) {
  extern __shared__ float smem[];
  const int group = h_dim / hkv;
  const int pitch = d_dim + 1;
  float* s_q = smem;                    // G x D scaled queries
  float* s_p = s_q + group * d_dim;     // G x S scores, then probabilities
  float* s_kv = s_p + group * s_len;    // kTileS x (D+1) cache tile

  const int kvh = blockIdx.x;
  const size_t b = blockIdx.y;
  const T* qb = q + (b * h_dim + (size_t)kvh * group) * d_dim;
  const size_t t_stride = (size_t)hkv * d_dim;
  const T* kb = k + b * s_len * t_stride + (size_t)kvh * d_dim;
  const T* vb = v + b * s_len * t_stride + (size_t)kvh * d_dim;
  const int* mb = mask + b * s_len;

  for (int i = threadIdx.x; i < group * d_dim; i += kThreads)
    s_q[i] = round_to(__fmul_rn(to_float(qb[i]), scale), qb);

  // scores, one tile of K at a time: thread -> (head, slot), sum over D
  for (int t0 = 0; t0 < s_len; t0 += kTileS) {
    const int n = min(kTileS, s_len - t0);
    __syncthreads();  // s_q is written, or the previous tile is consumed
    load_tile(s_kv, kb, t0, n, d_dim, pitch, t_stride);
    __syncthreads();
    for (int i = threadIdx.x; i < group * n; i += kThreads) {
      const int g = i / n, t = i % n;
      const float* qg = s_q + g * d_dim;
      const float* kt = s_kv + t * pitch;
      float s = 0.f;
      for (int d = 0; d < d_dim; ++d) s = __fmaf_rn(qg[d], kt[d], s);
      s_p[g * s_len + t0 + t] = mb[t0 + t] != 0 ? s : kNegInf;
    }
  }
  __syncthreads();

  // softmax over S: one warp per query head
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int g = warp; g < group; g += kWarps) {
    float* row = s_p + g * s_len;
    float m = kNegInf;
    for (int t = lane; t < s_len; t += 32) m = fmaxf(m, row[t]);
    m = warp_max(m);
    float sum = 0.f;
    for (int t = lane; t < s_len; t += 32) {
      const float e = expf(__fsub_rn(row[t], m));
      row[t] = e;
      sum = __fadd_rn(sum, e);
    }
    sum = warp_sum(sum);
    for (int t = lane; t < s_len; t += 32)
      row[t] = round_to(__fdiv_rn(row[t], sum), qb);
  }

  // out = p @ v, one tile of V at a time: thread -> (head, d) outputs,
  // each summed over the slots in order
  constexpr int kOutPerThread = kMaxGroup * 256 / kThreads;  // D <= 256
  float acc[kOutPerThread];
#pragma unroll
  for (int j = 0; j < kOutPerThread; ++j) acc[j] = 0.f;
  for (int t0 = 0; t0 < s_len; t0 += kTileS) {
    const int n = min(kTileS, s_len - t0);
    __syncthreads();  // probabilities are final, or the tile is consumed
    load_tile(s_kv, vb, t0, n, d_dim, pitch, t_stride);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kOutPerThread; ++j) {
      const int i = threadIdx.x + j * kThreads;
      if (i < group * d_dim) {
        const int g = i / d_dim, d = i % d_dim;
        const float* p = s_p + g * s_len + t0;
        float a = acc[j];
        for (int t = 0; t < n; ++t) a = __fmaf_rn(p[t], s_kv[t * pitch + d], a);
        acc[j] = a;
      }
    }
  }
  T* ob = out + (b * h_dim + (size_t)kvh * group) * d_dim;
#pragma unroll
  for (int j = 0; j < kOutPerThread; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i < group * d_dim) store(ob + i, acc[j]);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* mask,
           void* out, int b_dim, int h_dim, int hkv, int d_dim, int s_len,
           float scale, cudaStream_t stream) {
  const int group = h_dim / hkv;
  if (group > kMaxGroup || group * d_dim > kMaxGroup * 256)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)group * (d_dim + s_len) +
                       (size_t)kTileS * (d_dim + 1));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        prefill_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(hkv, b_dim);
  prefill_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), h_dim, hkv, d_dim,
      s_len, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v and out are bfloat16 when is_bf16 is nonzero, else float32.
// `scale` must already be representable in that type.  Launches on
// `stream`; allocates nothing.  Returns cudaGetLastError().
int prefill_attention_launch(const void* q, const void* k, const void* v,
                             const int* mask, void* out, int b_dim, int h_dim,
                             int hkv, int d_dim, int s_len, float scale,
                             int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, mask, out, b_dim, h_dim, hkv, d_dim,
                                 s_len, scale, s);
  return launch<float>(q, k, v, mask, out, b_dim, h_dim, hkv, d_dim, s_len,
                       scale, s);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
