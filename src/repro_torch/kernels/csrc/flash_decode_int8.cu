// One-token flash decode over an int8 KV cache for sm_90a, one thread-block
// cluster per (KV head, batch row), its CTAs splitting the cache slots.
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
//   out[b, h*G+g, :] = sum_t softmax_t(s[g, :]) * v[t, :]        float32
//
// q is (B, H, D) float32 or bfloat16; k8 and v8 (B, S, Hkv, D) int8;
// k_scale and v_scale (B, S, Hkv) bfloat16; length (B,) int32; out
// (B, H, D) float32.  A slot at or past length[b] adds exactly 0 (its
// score is -1e30 against a real maximum), so no CTA reads one; with
// length 0 every score is -1e30 and all S slots count alike, as in the
// reference.
//
// Bound on this card: at the serving path's shape (B 4, H = Hkv = 16,
// D 128, S 128) one call reads 2.1 MB of int8 cache (and 33 KB of scales)
// and does about 17 MFLOP: 0.65 us of bytes at 3.35 TB/s.  What bounds a
// call is latency: one round trip from device memory, a few barriers, and
// the dependent chains of the scores, the softmax and the PV sums.  The
// design:
//
//   * Grid (Hkv, B, splits), a cluster of `splits` CTAs along z per (KV
//     head, batch row).  `splits` is a function of the shape only (the
//     wrapper's split_count: enough CTAs to cover the H100's 132 SMs, at
//     least 32 slots a CTA, at most 8), never a tune knob: it sets the
//     summation order.  CTA r owns slots r*n .. r*n+n-1 (n = ceil(S /
//     splits)) and computes the partial (m, l, acc) of the online softmax
//     over those of them below length[b].
//   * The cache stays int8 until it reaches registers.  K and V arrive as
//     TMA boxes of up to 64 slots x D codes from 3-D tensor maps of the
//     cache, each on its own mbarrier, all of a CTA's first tiles issued at
//     entry, so V lands while the scores run; a CTA that owns more tiles
//     than its ring holds refills a stage as soon as it is consumed.  The
//     bfloat16 scales are read by the lanes beside them (a TMA box cannot
//     be 2 bytes wide), one tile ahead.  Each code is dequantized in a
//     register, __fmul_rn(code, scale): exact.
//   * Scores: warp w takes slots w, w+8, ... of a tile; lane l holds
//     codes 4l..4l+3 (and 128+4l.. at D 256) from one 32-bit shared-memory
//     read, q in registers, a fixed butterfly of __fadd_rn across the
//     lanes per slot.  The tile's max meets in shared memory; every warp
//     then updates m, rescales its own l and accumulators, and sums p * v
//     over its own slots with the accumulators in registers (lanes over
//     D).  Two block barriers a tile.
//   * The eight warps' (l, acc) are added in warp order in shared memory;
//     after a cluster barrier rank 0 reads every CTA's (m, l, acc) through
//     distributed shared memory and combines them in split order, with no
//     atomics:  M = max m_r,  out = sum_r acc_r e^(m_r - M) /
//     max(sum_r l_r e^(m_r - M), 1e-30).  A rerun gives the same bits.
//
// The summation order is not the dequantize-all plain version's, nor the
// earlier one-CTA kernel's (slots are split, and each warp sums its own
// slots), so the result agrees with both to float32 rounding: within
// 1e-5 of the plain version for every split count.
//
// A CTA takes at most 8 query heads per KV head (moonshot's G is 1,
// qwen2.5-3b's 8) and D at most 256, a multiple of 16 (the TMA box's row).
// exp is expf (no fast-math), and products and sums are written as
// __fmul_rn / __fmaf_rn / __fadd_rn / __fdiv_rn so nvcc's --fmad choice
// cannot change the rounding.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxGroup = 8;    // query heads per KV head
constexpr int kMaxD = 256;      // head dim
constexpr int kMaxSplits = 8;   // CTAs per cluster (portable)
constexpr int kTile = 64;       // slots a TMA box holds at most
constexpr int kSlotsPerWarp = kTile / kWarps;
constexpr int kMaxStages = 4;
constexpr size_t kSmemMax = 232448;
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

__host__ __device__ inline size_t align128(size_t v) {
  return (v + 127) & ~static_cast<size_t>(127);
}

// One CTA's slots and its shared-memory layout, in bytes: at most 137 KB
// (D 256, G 8), so every shape the launch takes fits.
struct Plan {
  int n_per;         // cache slots a CTA owns
  int box;           // slots per TMA box (a tile)
  int stages;        // ring stages, each a K tile and a V tile
  size_t tile_bytes; // one tile of codes, 128-aligned
  size_t off_small, off_part, off_ring, total;
};

// small: warp maxima, warp sums of l, m and l of the CTA, the combine's
// weights and denominators
constexpr size_t kSmallFloats = 2 * kWarps * kMaxGroup + 2 * kMaxGroup +
                                kMaxSplits * kMaxGroup + kMaxGroup;

inline Plan make_plan(int d_dim, int s_len, int splits, int kg) {
  Plan p;
  p.n_per = (s_len + splits - 1) / splits;
  p.box = p.n_per < kTile ? p.n_per : kTile;
  p.tile_bytes = align128((size_t)p.box * d_dim);
  const int tiles = (p.n_per + p.box - 1) / p.box;
  p.stages = tiles < kMaxStages ? tiles : kMaxStages;
  p.off_small = 128;  // the 2 x kMaxStages mbarriers first
  p.off_part = align128(p.off_small + 4 * kSmallFloats);
  p.off_ring = align128(p.off_part + 4 * (size_t)kMaxGroup * d_dim);
  const size_t ring = (size_t)p.stages * 2 * p.tile_bytes;
  const size_t acc = 4 * (size_t)kWarps * kg * d_dim;  // over the ring
  p.total = p.off_ring + (ring > acc ? ring : acc);
  return p;
}

// k_map, v_map: the caches as (D, Hkv, B*S) int8, a box of D codes by
// plan.box slots.  kG >= H / Hkv query heads; kDC = ceil(D / 128).
template <typename T, int kG, int kDC>
__global__ void __launch_bounds__(kThreads) flash_decode_int8_kernel(
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const T* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_scale,
    const __nv_bfloat16* __restrict__ v_scale, const int* __restrict__ length,
    float* __restrict__ out, int h_dim, int hkv, int d_dim, int s_len,
    float inv_sqrt_d, Plan plan) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int group = h_dim / hkv;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  uint64_t* k_full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* v_full = k_full + kMaxStages;
  float* s_wmax = reinterpret_cast<float*>(smem + plan.off_small);
  float* s_wl = s_wmax + kWarps * kMaxGroup;  // warps' l, then ...
  float* s_m = s_wl + kWarps * kMaxGroup;     // ... the CTA's m
  float* s_l = s_m + kMaxGroup;               // ... and l
  float* s_wt = s_l + kMaxGroup;              // rank 0: e^(m_r - M)
  float* s_den = s_wt + kMaxSplits * kMaxGroup;
  float* s_part = reinterpret_cast<float*>(smem + plan.off_part);  // G x D
  unsigned char* ring = smem + plan.off_ring;
  float* s_acc = reinterpret_cast<float*>(ring);  // warps x G x D, at the end

  const int len = length[b];
  const int s_end = len > 0 ? min(len, s_len) : s_len;
  const int t0 = rank * plan.n_per;
  const int n_valid = max(0, min(t0 + plan.n_per, s_end) - t0);
  const int n_tiles = (n_valid + plan.box - 1) / plan.box;
  const int row0 = b * s_len + t0;  // this CTA's first slot in (B*S)
  const uint32_t tile_tx = (uint32_t)(plan.box * d_dim);

  if (threadIdx.x == 0) {
    for (int s = 0; s < plan.stages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
    }
    hopper::fence_mbar_init();
    for (int i = 0; i < n_tiles && i < plan.stages; ++i) {
      unsigned char* kt = ring + (size_t)i * 2 * plan.tile_bytes;
      mbar_expect_tx(&k_full[i], tile_tx);
      hopper::tma_load_3d(kt, &k_map, 0, kvh, row0 + i * plan.box,
                          &k_full[i]);
      mbar_expect_tx(&v_full[i], tile_tx);
      hopper::tma_load_3d(kt + plan.tile_bytes, &v_map, 0, kvh,
                          row0 + i * plan.box, &v_full[i]);
    }
  }

  // the lane's scales: slot warp + 8 * lane of a tile, for lanes < 8
  const __nv_bfloat16* ksb = k_scale + (size_t)row0 * hkv + kvh;
  const __nv_bfloat16* vsb = v_scale + (size_t)row0 * hkv + kvh;
  auto load_scales = [&](int tile, float& ks, float& vs) {
    const int t = tile * plan.box + warp + kWarps * lane;
    ks = vs = 0.f;
    if (lane < kSlotsPerWarp && warp + kWarps * lane < plan.box &&
        t < n_valid) {
      ks = __bfloat162float(ksb[(size_t)t * hkv]);
      vs = __bfloat162float(vsb[(size_t)t * hkv]);
    }
  };
  float ksc = 0.f, vsc = 0.f;
  if (n_tiles > 0) load_scales(0, ksc, vsc);

  // the group's queries, scaled, in registers: lane l holds d = 128 c +
  // 4 l + e
  const T* qb = q + ((size_t)b * h_dim + (size_t)kvh * group) * d_dim;
  float qr[kG][kDC][4];
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int c = 0; c < kDC; ++c) {
      const int d = 128 * c + 4 * lane;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        qr[g][c][e] = (g < group && d < d_dim)
                          ? __fmul_rn(to_float(qb[g * d_dim + d + e]),
                                      inv_sqrt_d)
                          : 0.f;
    }

  float m_run[kG], l_w[kG], acc[kG][kDC][4];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m_run[g] = kNegInf;
    l_w[g] = 0.f;
#pragma unroll
    for (int c = 0; c < kDC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][c][e] = 0.f;
  }
  __syncthreads();  // the barriers are initialized

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % plan.stages;
    const uint32_t par = (uint32_t)(i / plan.stages) & 1u;
    const int n_in = min(plan.box, n_valid - i * plan.box);
    const int tg = t0 + i * plan.box;  // the tile's first slot in S
    float ksn = 0.f, vsn = 0.f;
    if (i + 1 < n_tiles) load_scales(i + 1, ksn, vsn);
    const unsigned char* kt = ring + (size_t)st * 2 * plan.tile_bytes;
    const unsigned char* vt = kt + plan.tile_bytes;

    // scores of this warp's slots; lane j keeps slot j's
    float my_s[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) my_s[g] = -INFINITY;
    mbar_wait(&k_full[st], par);
#pragma unroll
    for (int j = 0; j < kSlotsPerWarp; ++j) {
      const int t = warp + kWarps * j;
      if (t >= n_in) break;
      const float sc = __shfl_sync(~0u, ksc, j);
      float kv[kDC][4];
#pragma unroll
      for (int c = 0; c < kDC; ++c) {
        const int d = 128 * c + 4 * lane;
        const uint32_t w =
            d < d_dim ? *reinterpret_cast<const uint32_t*>(kt + t * d_dim + d)
                      : 0u;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          kv[c][e] = __fmul_rn((float)(int8_t)(w >> (8 * e)), sc);
      }
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < kDC; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) s = __fmaf_rn(qr[g][c][e], kv[c][e], s);
        s = warp_sum(s);
        if (lane == j) my_s[g] = tg + t < len ? s : kNegInf;
      }
    }
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const float wm = warp_max(my_s[g]);
      if (lane == 0) s_wmax[warp * kMaxGroup + g] = wm;
    }
    __syncthreads();

    // every warp updates m alike; rescales its own l and accumulators
    float p[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      float mt = s_wmax[g];
#pragma unroll
      for (int w = 1; w < kWarps; ++w)
        mt = fmaxf(mt, s_wmax[w * kMaxGroup + g]);
      const float m_new = fmaxf(m_run[g], mt);
      const float corr = expf(__fsub_rn(m_run[g], m_new));
      m_run[g] = m_new;
      p[g] = expf(__fsub_rn(my_s[g], m_new));  // 0 on lanes with no slot
      l_w[g] = __fadd_rn(__fmul_rn(l_w[g], corr), warp_sum(p[g]));
#pragma unroll
      for (int c = 0; c < kDC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][c][e] = __fmul_rn(acc[g][c][e], corr);
    }

    // p @ v over this warp's slots, in slot order
    mbar_wait(&v_full[st], par);
#pragma unroll
    for (int j = 0; j < kSlotsPerWarp; ++j) {
      const int t = warp + kWarps * j;
      if (t >= n_in) break;
      const float sc = __shfl_sync(~0u, vsc, j);
      float vv[kDC][4];
#pragma unroll
      for (int c = 0; c < kDC; ++c) {
        const int d = 128 * c + 4 * lane;
        const uint32_t w =
            d < d_dim ? *reinterpret_cast<const uint32_t*>(vt + t * d_dim + d)
                      : 0u;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          vv[c][e] = __fmul_rn((float)(int8_t)(w >> (8 * e)), sc);
      }
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float pj = __shfl_sync(~0u, p[g], j);
#pragma unroll
        for (int c = 0; c < kDC; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[g][c][e] = __fmaf_rn(pj, vv[c][e], acc[g][c][e]);
      }
    }
    ksc = ksn;
    vsc = vsn;
    __syncthreads();  // the stage and the warp maxima are consumed
    if (threadIdx.x == 0 && i + plan.stages < n_tiles) {
      const int nt = i + plan.stages;
      mbar_expect_tx(&k_full[st], tile_tx);
      hopper::tma_load_3d(ring + (size_t)st * 2 * plan.tile_bytes, &k_map, 0,
                          kvh, row0 + nt * plan.box, &k_full[st]);
      mbar_expect_tx(&v_full[st], tile_tx);
      hopper::tma_load_3d(ring + (size_t)st * 2 * plan.tile_bytes +
                              plan.tile_bytes,
                          &v_map, 0, kvh, row0 + nt * plan.box, &v_full[st]);
    }
  }

  // the warps' partials meet in shared memory (over the ring, now idle) and
  // are added in warp order
#pragma unroll
  for (int g = 0; g < kG; ++g) {
#pragma unroll
    for (int c = 0; c < kDC; ++c) {
      const int d = 128 * c + 4 * lane;
      if (d < d_dim)
        *reinterpret_cast<float4*>(s_acc + (warp * kG + g) * d_dim + d) =
            make_float4(acc[g][c][0], acc[g][c][1], acc[g][c][2],
                        acc[g][c][3]);
    }
    if (lane == 0) s_wl[warp * kMaxGroup + g] = l_w[g];
    if (threadIdx.x == 0) s_m[g] = m_run[g];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kG * d_dim; i += kThreads) {
    float s = s_acc[i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s = __fadd_rn(s, s_acc[w * kG * d_dim + i]);
    s_part[i] = s;
  }
  if (threadIdx.x < kG) {
    float l = s_wl[threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      l = __fadd_rn(l, s_wl[w * kMaxGroup + threadIdx.x]);
    s_l[threadIdx.x] = l;
  }
  cluster.sync();  // every CTA's (m, l, acc) is written

  if (rank == 0) {
    // rank 0 combines the splits' partials in split order
    if (threadIdx.x < group) {
      const int g = threadIdx.x;
      float m_max = -INFINITY;
      for (int r = 0; r < splits; ++r)
        m_max = fmaxf(m_max, cluster.map_shared_rank(s_m, r)[g]);
      float den = 0.f;
      for (int r = 0; r < splits; ++r) {
        const float w = expf(__fsub_rn(cluster.map_shared_rank(s_m, r)[g],
                                       m_max));
        s_wt[r * kMaxGroup + g] = w;
        den = __fmaf_rn(cluster.map_shared_rank(s_l, r)[g], w, den);
      }
      s_den[g] = fmaxf(den, 1e-30f);
    }
    __syncthreads();
    float* ob = out + ((size_t)b * h_dim + (size_t)kvh * group) * d_dim;
    for (int i = threadIdx.x; i < group * d_dim; i += kThreads) {
      const int g = i / d_dim;
      float num = 0.f;
      for (int r = 0; r < splits; ++r)
        num = __fmaf_rn(cluster.map_shared_rank(s_part, r)[i],
                        s_wt[r * kMaxGroup + g], num);
      ob[i] = __fdiv_rn(num, s_den[g]);
    }
  }
  cluster.sync();  // rank 0 is done with its peers' shared memory
}

template <typename T, int kG, int kDC>
int launch(const void* q, const int8_t* k8, const void* k_scale,
           const int8_t* v8, const void* v_scale, const int* length,
           float* out, int b_dim, int h_dim, int hkv, int d_dim, int s_len,
           int splits, float inv_sqrt_d, cudaStream_t stream) {
  const Plan plan = make_plan(d_dim, s_len, splits, kG);
  if (plan.total > kSmemMax) return (int)cudaErrorInvalidValue;
  const uint64_t dims[3] = {(uint64_t)d_dim, (uint64_t)hkv,
                            (uint64_t)b_dim * s_len};
  const uint64_t strides[2] = {(uint64_t)d_dim, (uint64_t)hkv * d_dim};
  const uint32_t box[3] = {(uint32_t)d_dim, 1, (uint32_t)plan.box};
  CUtensorMap k_map, v_map;
  if (hopper::tensor_map_3d(k8, CU_TENSOR_MAP_DATA_TYPE_UINT8, dims, strides,
                            box, &k_map) != 0 ||
      hopper::tensor_map_3d(v8, CU_TENSOR_MAP_DATA_TYPE_UINT8, dims, strides,
                            box, &v_map) != 0)
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_decode_int8_kernel<T, kG, kDC>;
  if (plan.total > 48 * 1024) {
    const int set = hopper::func_attribute_at_least<
        flash_decode_int8_kernel<T, kG, kDC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize>((int)plan.total);
    if (set != 0) return set;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(hkv, b_dim, splits);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = plan.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, k_map, v_map, static_cast<const T*>(q),
      static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale), length, out, h_dim, hkv,
      d_dim, s_len, inv_sqrt_d, plan);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the template instance for G query heads a KV head and head dim D
template <typename T>
int dispatch(const void* q, const int8_t* k8, const void* k_scale,
             const int8_t* v8, const void* v_scale, const int* length,
             float* out, int b_dim, int h_dim, int hkv, int d_dim, int s_len,
             int splits, float inv_sqrt_d, cudaStream_t stream) {
  const int group = h_dim / hkv;
#define FD_CASE(G, DC)                                                     \
  if (group <= G && d_dim <= 128 * DC)                                     \
    return launch<T, G, DC>(q, k8, k_scale, v8, v_scale, length, out,      \
                            b_dim, h_dim, hkv, d_dim, s_len, splits,       \
                            inv_sqrt_d, stream);
  FD_CASE(1, 1) FD_CASE(2, 1) FD_CASE(4, 1) FD_CASE(8, 1)
  FD_CASE(1, 2) FD_CASE(2, 2) FD_CASE(4, 2) FD_CASE(8, 2)
#undef FD_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q is bfloat16 when q_bf16 is nonzero, else float32; the scales are
// bfloat16, the output float32.  `inv_sqrt_d` is 1/sqrt(D) in float32.
// `splits` CTAs share each (KV head, batch row): 1 to 8 (a CTA whose
// slots all lie past S or past the row's length contributes nothing).  k8 and v8 are 16-byte aligned and D a multiple of 16
// (the tensor maps').  Launches on `stream`; allocates nothing.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for what it does not take.
int flash_decode_int8_launch(const void* q, const int8_t* k8,
                             const void* k_scale, const int8_t* v8,
                             const void* v_scale, const int* length,
                             float* out, int b_dim, int h_dim, int hkv,
                             int d_dim, int s_len, int splits,
                             float inv_sqrt_d, int q_bf16, void* stream) {
  if (hkv < 1 || h_dim % hkv || h_dim / hkv > kMaxGroup || d_dim < 16 ||
      d_dim > kMaxD || d_dim % 16 || s_len < 1 || splits < 1 ||
      splits > kMaxSplits || reinterpret_cast<uintptr_t>(k8) % 16 ||
      reinterpret_cast<uintptr_t>(v8) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (q_bf16)
    return dispatch<__nv_bfloat16>(q, k8, k_scale, v8, v_scale, length, out,
                                   b_dim, h_dim, hkv, d_dim, s_len, splits,
                                   inv_sqrt_d, s);
  return dispatch<float>(q, k8, k_scale, v8, v_scale, length, out, b_dim,
                         h_dim, hkv, d_dim, s_len, splits, inv_sqrt_d, s);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
