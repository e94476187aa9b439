// One-token flash decode over an int8 KV cache for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py::
// flash_decode_int8: the attention of one new token over a cache stored as
// int8 codes with one bfloat16 scale per (slot, KV head), which every
// attention layer of an LM served with kv_cache_dtype="int8" runs once per
// decode step and per scan-prefill position.  For each batch row b and KV
// head h, with the G = H / Hkv query heads of that KV head:
//
//   qs[g, d]  = float(q[b, h*G+g, d]) * inv_sqrt_d     (1/sqrt(D) rounded
//               to float32, as the Pallas kernel; the oracle's q / sqrt(d)
//               is the same multiplication once XLA compiles it)
//   k[t, d]   = float(k8[b, t, h, d]) * float(k_scale[b, t, h])   (exact)
//   s[g, t]   = sum_d qs[g, d] * k[t, d],   -1e30 where t >= length[b]
//   online softmax over tiles of slots, as the Pallas kernel runs it:
//     m' = max(m, max_t s);  p = exp(s - m');  c = exp(m - m')
//     l' = l * c + sum_t p;  acc' = acc * c + sum_t p[t] * v[t, :]
//   out[b, h*G+g, :] = acc / max(l, 1e-30)                      float32
//
// q is (B, H, D) float32 or bfloat16; k8 and v8 (B, S, Hkv, D) int8;
// k_scale and v_scale (B, S, Hkv) bfloat16; length (B,) int32; out
// (B, H, D) float32.
//
// Bound on this card: at the serving path's shape (B 4, H = Hkv = 16,
// D 128, S 128) one call reads 2.1 MB of int8 cache (and 33 KB of scales)
// and does about 17 MFLOP: 0.64 us of bytes at 3.35 TB/s.  A slot past
// `length` adds exactly 0 to the online softmax (its score is -1e30), so
// the block stops at its row's length and reads only the valid slots.
// The Pallas grid's sequential kv axis becomes a loop inside the block;
// its parallel axes become the grid: one block per (KV head, batch row),
// 64 blocks at the serving shape.  In each block:
//
//   * the scaled queries of the group sit in shared memory;
//   * one tile of 64 slots of K is read as int8 (each 128-byte row by
//     consecutive threads) and dequantized into shared memory as float32,
//     row pitch D + 1 so the score threads, which read different rows, hit
//     different banks; nothing is dequantized to device memory;
//   * one thread per (query head, slot) score, summed over D in order;
//     one warp per query head updates (m, l) and writes p in place;
//   * the V tile is dequantized into the same buffer, and one thread per
//     (query head, d) output keeps its accumulator in registers across
//     tiles, summing its tile's slots in order.
//
// A block takes at most 8 query heads per KV head (one warp each for the
// softmax): moonshot's G is 1, qwen2.5-3b's 8.
//
// exp is expf (no fast-math), and products and sums are written as
// __fmul_rn / __fmaf_rn / __fadd_rn / __fdiv_rn so nvcc's --fmad choice
// cannot change the rounding.  The result agrees with the dequantize-all
// oracle to float32 rounding (another summation order, and the online
// softmax's rescaling).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxGroup = kWarps;  // query heads per KV head: a warp each
constexpr int kMaxD = 256;     // head dim
constexpr int kTileS = 64;     // cache slots staged at a time
constexpr int kOutPerThread = kMaxGroup * kMaxD / kThreads;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(~0u, v, o));
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

// Dequantize slots t0 .. t0+n-1 of one KV head into dst (row pitch
// `pitch`), all threads reading consecutive codes of each row.
__device__ __forceinline__ void load_tile(float* dst, const int8_t* codes,
                                          const __nv_bfloat16* scales, int t0,
                                          int n, int d_dim, int pitch,
                                          size_t t_stride, int hkv) {
  for (int i = threadIdx.x; i < n * d_dim; i += kThreads) {
    const int t = i / d_dim, d = i % d_dim;
    const float scale = __bfloat162float(scales[(size_t)(t0 + t) * hkv]);
    dst[t * pitch + d] =
        __fmul_rn((float)codes[(t0 + t) * t_stride + d], scale);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_decode_int8_kernel(
    const T* __restrict__ q, const int8_t* __restrict__ k8,
    const __nv_bfloat16* __restrict__ k_scale, const int8_t* __restrict__ v8,
    const __nv_bfloat16* __restrict__ v_scale, const int* __restrict__ length,
    float* __restrict__ out, int h_dim, int hkv, int d_dim, int s_len,
    float inv_sqrt_d) {
  extern __shared__ float smem[];
  const int group = h_dim / hkv;
  const int pitch = d_dim + 1;
  float* s_q = smem;                    // G x D scaled queries
  float* s_p = s_q + group * d_dim;     // G x kTileS scores, then p
  float* s_corr = s_p + group * kTileS; // G rescale factors of this tile
  float* s_l = s_corr + kMaxGroup;      // G softmax denominators
  float* s_kv = s_l + kMaxGroup;        // kTileS x (D+1) dequantized tile

  const int kvh = blockIdx.x;
  const size_t b = blockIdx.y;
  const T* qb = q + (b * h_dim + (size_t)kvh * group) * d_dim;
  const size_t t_stride = (size_t)hkv * d_dim;
  const int8_t* kb = k8 + b * s_len * t_stride + (size_t)kvh * d_dim;
  const int8_t* vb = v8 + b * s_len * t_stride + (size_t)kvh * d_dim;
  const __nv_bfloat16* ksb = k_scale + b * s_len * hkv + kvh;
  const __nv_bfloat16* vsb = v_scale + b * s_len * hkv + kvh;
  const int len = length[b];
  // slots at or past `len` add exactly 0; with no valid slot every score
  // is -1e30 and all slots count alike, as in the reference
  const int s_end = len > 0 ? min(len, s_len) : s_len;

  for (int i = threadIdx.x; i < group * d_dim; i += kThreads)
    s_q[i] = __fmul_rn(to_float(qb[i]), inv_sqrt_d);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float m_run = kNegInf, l_run = 0.f;  // of query head `warp`, if any
  float acc[kOutPerThread];
#pragma unroll
  for (int j = 0; j < kOutPerThread; ++j) acc[j] = 0.f;

  for (int t0 = 0; t0 < s_end; t0 += kTileS) {
    const int n = min(kTileS, s_end - t0);
    __syncthreads();  // s_q is written, or the previous V tile is consumed
    load_tile(s_kv, kb, ksb, t0, n, d_dim, pitch, t_stride, hkv);
    __syncthreads();
    for (int i = threadIdx.x; i < group * n; i += kThreads) {
      const int g = i / n, t = i % n;
      const float* qg = s_q + g * d_dim;
      const float* kt = s_kv + t * pitch;
      float s = 0.f;
      for (int d = 0; d < d_dim; ++d) s = __fmaf_rn(qg[d], kt[d], s);
      s_p[g * kTileS + t] = t0 + t < len ? s : kNegInf;
    }
    __syncthreads();
    // online softmax: warp g owns query head g (G <= kWarps)
    if (warp < group) {
      float* row = s_p + warp * kTileS;
      float mt = kNegInf;
      for (int t = lane; t < n; t += 32) mt = fmaxf(mt, row[t]);
      mt = warp_max(mt);
      const float m_new = fmaxf(m_run, mt);
      float sum = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float e = expf(__fsub_rn(row[t], m_new));
        row[t] = e;
        sum = __fadd_rn(sum, e);
      }
      sum = warp_sum(sum);
      const float corr = expf(__fsub_rn(m_run, m_new));
      m_run = m_new;
      l_run = __fadd_rn(__fmul_rn(l_run, corr), sum);
      if (lane == 0) s_corr[warp] = corr;
    }
    __syncthreads();
    load_tile(s_kv, vb, vsb, t0, n, d_dim, pitch, t_stride, hkv);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kOutPerThread; ++j) {
      const int i = threadIdx.x + j * kThreads;
      if (i < group * d_dim) {
        const int g = i / d_dim, d = i % d_dim;
        const float* p = s_p + g * kTileS;
        float pv = 0.f;
        for (int t = 0; t < n; ++t)
          pv = __fmaf_rn(p[t], s_kv[t * pitch + d], pv);
        const float corr = s_corr[g];
        acc[j] = __fadd_rn(__fmul_rn(acc[j], corr), pv);
      }
    }
  }
  __syncthreads();
  // l of each head: the lanes of its warp all hold it; lane 0 publishes it
  if (warp < group && lane == 0) s_l[warp] = l_run;
  __syncthreads();
  float* ob = out + (b * h_dim + (size_t)kvh * group) * d_dim;
#pragma unroll
  for (int j = 0; j < kOutPerThread; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i < group * d_dim)
      ob[i] = __fdiv_rn(acc[j], fmaxf(s_l[i / d_dim], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const int8_t* k8, const void* k_scale,
           const int8_t* v8, const void* v_scale, const int* length,
           float* out, int b_dim, int h_dim, int hkv, int d_dim, int s_len,
           float inv_sqrt_d, cudaStream_t stream) {
  const int group = h_dim / hkv;
  if (group > kMaxGroup || d_dim > kMaxD) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)group * (d_dim + kTileS) + 2 * kMaxGroup +
                       (size_t)kTileS * (d_dim + 1));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_decode_int8_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(hkv, b_dim);
  flash_decode_int8_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), k8,
      static_cast<const __nv_bfloat16*>(k_scale), v8,
      static_cast<const __nv_bfloat16*>(v_scale), length, out, h_dim, hkv,
      d_dim, s_len, inv_sqrt_d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q is bfloat16 when q_bf16 is nonzero, else float32; the scales are
// bfloat16, the output float32.  `inv_sqrt_d` is 1/sqrt(D) in float32.
// Launches on `stream`; allocates nothing.  Returns cudaGetLastError().
int flash_decode_int8_launch(const void* q, const int8_t* k8,
                             const void* k_scale, const int8_t* v8,
                             const void* v_scale, const int* length,
                             float* out, int b_dim, int h_dim, int hkv,
                             int d_dim, int s_len, float inv_sqrt_d,
                             int q_bf16,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (q_bf16)
    return launch<__nv_bfloat16>(q, k8, k_scale, v8, v_scale, length, out,
                                 b_dim, h_dim, hkv, d_dim, s_len, inv_sqrt_d,
                                 s);
  return launch<float>(q, k8, k_scale, v8, v_scale, length, out, b_dim, h_dim,
                       hkv, d_dim, s_len, inv_sqrt_d, s);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
