// One-query cached attention (GQA) for sm_90a, one thread-block cluster
// per (KV head, batch row).
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
// (for float32 inputs the two sums run in float64 and round once: Acc)
//
// q is (B, H, D), k and v (B, S, Hkv, D), mask (B, S) int32, all of one
// type (float32 or bfloat16); the G = H / Hkv query heads of KV head h are
// heads h*G .. h*G+G-1, as in the reference's grouped layout.
//
// Bound on this card: at the serving path's shape (B 4, H 16, Hkv 2,
// D 128, S 128, bfloat16) one call reads 256 KB of cache and does about
// 4 MFLOP, 0.17 us of bytes at 3.35 TB/s; any launch costs more than that.
// What bounds a call is latency: the cache's round trip from device
// memory, then the chains of dependent float32 adds.  The design:
//
//   * One cluster of `cs` CTAs (a power of two up to 16, chosen by the
//     wrapper from S and D; a launch config) per (KV head, batch row): 64
//     CTAs at the serving shape instead of 8.  CTA r scores the slots
//     r*n .. r*n+n-1 (n = ceil(S / cs)) and sums the output columns
//     r*D/cs .. (r+1)*D/cs - 1 of every query head of the group.
//   * Every copy is issued at entry, on two mbarriers, so V arrives while
//     the scores are computed: its slots' K rows (one cp.async.bulk of D
//     elements each, into rows padded by 16 bytes, so the threads of a
//     warp, which read different rows, do not collide in one bank) and
//     its D/cs columns of every slot's V row (TMA boxes of up to 256 slots
//     from a 3-D tensor map of the cache; one 32-byte bulk copy a slot
//     was slower: the copy engine's per-request cost set the time).
//   * The softmax keeps attend_full's rounding: each CTA writes its raw
//     scores, and after a cluster barrier every CTA reads the whole row
//     from its peers' shared memory (distributed shared memory) and
//     computes max, exp, the sum and each rounded probability over the
//     whole row, exactly as the one-block kernel did.  The cluster is a
//     launch config: every CTA runs the same softmax on the same row, so
//     no cluster size changes a bit.
//   * Fixed summation orders: each score sums over D in order, the row's
//     sum is one warp's (lane l adds slots l, l+32, ... in order, then a
//     butterfly), and each output sums over the slots 0 .. S-1 in order.
//     exp is expf (no fast-math), and products and sums are written as
//     __fmaf_rn / __fadd_rn / __fdiv_rn so nvcc's --fmad choice cannot
//     change the rounding.  For bfloat16 inputs the bits are those of the
//     earlier one-block kernel; for float32 ones the score and output
//     sums are float64 (Acc below).
//   * A second cluster barrier, split into arrive and wait, keeps a CTA's
//     shared memory alive until every peer has read its scores.
//
// Shared memory per CTA (Plan below; kernels/prefill_attention.py's
// smem_bytes mirrors it): the group's scaled queries, this CTA's scores,
// its K rows (then, reusing the space, the whole row's G x S scores and
// probabilities), and its V columns of every slot (S rounded up to whole
// TMA boxes).
//
// A long cache, one that no cluster size can stage whole (float32 at
// recurrentgemma's full window: S 2048, D 256, G 16), streams its V
// columns through a ring of kRing boxes instead: the PV sum takes box
// after box as it lands (the slots in the same order, so the same bits),
// and each freed box is refilled with the box kRing ahead.  That needs
// one (head, column) a thread, G x D / cs <= kThreads.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;
using hopper::bulk_load;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxGroup = 16;       // query heads per KV head
constexpr int kMaxCluster = 16;     // CTAs per (KV head, batch row)
constexpr size_t kSmemMax = 232448; // bytes of shared memory a CTA can use
constexpr int kBoxMax = 256;        // slots a TMA box of V holds
constexpr int kRing = 2;            // V boxes staged at once, long caches
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

// The accumulator of a score's sum over D and an output's sum over the
// slots: float32 for bfloat16 inputs (the reference's rounding, in order);
// float64 for float32 inputs, where every product is exact and the sum is
// rounded once, to float32, at its end.  A float32 chain of D 256 products
// left a score 1.8e-6 from the plain version's (recurrentgemma's local
// attention), over the 1e-6 contract: its error grows with the chain.
template <typename T> struct Acc { using type = float; };
template <> struct Acc<float> { using type = double; };
__device__ __forceinline__ float fma_acc(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_acc(float a, float b, double c) {
  return __fma_rn(static_cast<double>(a), static_cast<double>(b), c);
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

__host__ __device__ inline size_t align128(size_t v) {
  return (v + 127) & ~static_cast<size_t>(127);
}

// One CTA's share of the work and its shared-memory layout, in bytes.
struct Plan {
  int n_per;       // cache slots a CTA scores
  int dc;          // output columns a CTA sums
  int p_pitch;     // floats per row of the G x S score matrix
  int k_pitch;     // bytes per staged K row
  int v_box;       // slots per TMA box of V
  int v_rows;      // V rows staged: S rounded up to whole boxes
  int ring;        // 1: V streamed through kRing boxes (a long cache)
  size_t v_pitch;  // bytes between the ring's boxes
  size_t off_q, off_own, off_r, off_v, total;
};

__host__ __device__ inline Plan make_full_plan(int group, int d_dim,
                                               int s_len, int cs, int elem) {
  Plan p;
  p.n_per = (s_len + cs - 1) / cs;
  p.dc = d_dim / cs;
  p.p_pitch = s_len + 1;  // rows of two heads in one warp use other banks
  p.k_pitch = d_dim * elem + 16;
  p.off_q = 128;          // two mbarriers first
  p.off_own = align128(p.off_q + 4 * (size_t)group * (d_dim + 1));
  p.off_r = align128(p.off_own + 4 * (size_t)group * p.n_per);
  size_t r_bytes = (size_t)p.n_per * p.k_pitch;
  const size_t p_bytes = 4 * (size_t)group * p.p_pitch;
  if (p_bytes > r_bytes) r_bytes = p_bytes;
  p.off_v = align128(p.off_r + r_bytes);
  p.v_box = s_len < kBoxMax ? s_len : kBoxMax;
  p.v_rows = (s_len + p.v_box - 1) / p.v_box * p.v_box;
  p.ring = 0;
  p.v_pitch = align128((size_t)p.v_box * p.dc * elem);
  p.total = p.off_v + (size_t)p.v_rows * p.dc * elem;
  return p;
}

// the cluster sizes whose CTAs take whole 16-byte column slices of V
__host__ __device__ inline bool slices_ok(int d_dim, int cs, int elem) {
  return d_dim % cs == 0 && (d_dim / cs * elem) % 16 == 0;
}

// The plan of `cs` CTAs: every V slot staged at entry, or, for a cache
// that no cluster size can stage whole, V streamed through the ring.
__host__ __device__ inline Plan make_plan(int group, int d_dim, int s_len,
                                          int cs, int elem) {
  Plan p = make_full_plan(group, d_dim, s_len, cs, elem);
  for (int c = 1; c <= kMaxCluster; c *= 2)
    if (slices_ok(d_dim, c, elem) &&
        make_full_plan(group, d_dim, s_len, c, elem).total <= kSmemMax)
      return p;
  p.ring = 1;
  p.total = p.off_v + kRing * p.v_pitch;
  return p;
}

// v_map: the V cache as (D, Hkv, B*S), a box of D/cs columns by v_box slots
template <typename T>
__global__ void __launch_bounds__(kThreads) prefill_attention_kernel(
    const __grid_constant__ CUtensorMap v_map, const T* __restrict__ q,
    const T* __restrict__ k, const int* __restrict__ mask, T* __restrict__ out,
    int h_dim, int hkv, int d_dim, int s_len, float scale, Plan plan) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int group = h_dim / hkv;
  const int kvh = blockIdx.x / cs;
  const size_t b = blockIdx.y;
  const int n_per = plan.n_per, dc = plan.dc, pitch = plan.p_pitch;
  const int t0 = rank * n_per;
  const int n_here = max(0, min(n_per, s_len - t0));

  // [0] K; [1] V, or [1 + j] the ring's box j
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* s_q = reinterpret_cast<float*>(smem + plan.off_q);      // G x (D+1)
  float* s_own = reinterpret_cast<float*>(smem + plan.off_own);  // G x n_per
  unsigned char* s_k = smem + plan.off_r;       // n_per K rows, then ...
  float* s_p = reinterpret_cast<float*>(smem + plan.off_r);  // ... G x S
  T* s_v = reinterpret_cast<T*>(smem + plan.off_v);          // v_rows x dc

  const size_t t_stride = (size_t)hkv * d_dim;  // elements between slots
  const T* kb = k + b * s_len * t_stride + (size_t)kvh * d_dim;

  // box j of this CTA's V columns into the ring (thread 0)
  const int n_boxes = plan.v_rows / plan.v_box;
  auto load_box = [&](int j) {
    const int slot = j % kRing;
    mbar_expect_tx(&bar[1 + slot],
                   (uint32_t)((size_t)plan.v_box * dc * sizeof(T)));
    hopper::tma_load_3d(smem + plan.off_v + slot * plan.v_pitch, &v_map,
                        rank * dc, kvh, (int)(b * s_len) + j * plan.v_box,
                        &bar[1 + slot]);
  };

  // every copy first: this CTA's K rows and its V columns of every slot
  // (of the ring's first boxes, for a long cache)
  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + (plan.ring ? kRing : 1); ++i)
      mbar_init(&bar[i], 1);
    hopper::fence_mbar_init();
    mbar_expect_tx(&bar[0], (uint32_t)((size_t)n_here * d_dim * sizeof(T)));
    if (plan.ring) {
      for (int j = 0; j < kRing && j < n_boxes; ++j) load_box(j);
    } else {
      mbar_expect_tx(&bar[1],
                     (uint32_t)((size_t)plan.v_rows * dc * sizeof(T)));
      for (int r = 0; r < s_len; r += plan.v_box)
        hopper::tma_load_3d(s_v + (size_t)r * dc, &v_map, rank * dc, kvh,
                            (int)(b * s_len) + r, &bar[1]);
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < n_here; t += kThreads)
    bulk_load(s_k + (size_t)t * plan.k_pitch, kb + (size_t)(t0 + t) * t_stride,
              (uint32_t)(d_dim * sizeof(T)), &bar[0]);

  const T* qb = q + (b * h_dim + (size_t)kvh * group) * d_dim;
  for (int i = threadIdx.x; i < group * d_dim; i += kThreads) {
    const int g = i / d_dim, d = i - g * d_dim;
    s_q[g * (d_dim + 1) + d] = round_to(__fmul_rn(to_float(qb[i]), scale), qb);
  }
  __syncthreads();
  mbar_wait(&bar[0], 0);

  // this CTA's scores: thread -> (slot, head), heads fastest, summed over
  // D in order
  const int* mb = mask + b * s_len;
  for (int i = threadIdx.x; i < group * n_here; i += kThreads) {
    const int t = i / group, g = i - t * group;
    const float* qg = s_q + g * (d_dim + 1);
    const T* kt = reinterpret_cast<const T*>(s_k + (size_t)t * plan.k_pitch);
    typename Acc<T>::type s = 0;
    for (int d = 0; d < d_dim; ++d) s = fma_acc(qg[d], to_float(kt[d]), s);
    s_own[g * n_per + t] = mb[t0 + t] != 0 ? static_cast<float>(s) : kNegInf;
  }
  cluster.sync();  // every CTA's scores are written; its K rows consumed

  // the whole row, read from the CTAs that own its slots
#pragma unroll 4
  for (int i = threadIdx.x; i < group * s_len; i += kThreads) {
    const int g = i / s_len, t = i - g * s_len;
    const int owner = t / n_per;
    const float* src = cluster.map_shared_rank(s_own, owner);
    s_p[g * pitch + t] = src[g * n_per + (t - owner * n_per)];
  }
  // done with the peers' shared memory (they wait for this before exiting)
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  __syncthreads();

  // softmax over S: one warp per query head
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int g = warp; g < group; g += kWarps) {
    float* row = s_p + g * pitch;
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
  __syncthreads();

  // out = p @ v over this CTA's columns: thread -> (head, column), each
  // output summed over the slots in order
  T* ob = out + (b * h_dim + (size_t)kvh * group) * d_dim + (size_t)rank * dc;
  if (plan.ring) {
    const int i = threadIdx.x;
    const bool mine = i < group * dc;
    const int g = mine ? i / dc : 0, dl = mine ? i - g * dc : 0;
    const float* pg = s_p + g * pitch;
    typename Acc<T>::type a = 0;
    for (int j = 0; j < n_boxes; ++j) {
      const int slot = j % kRing, t0b = j * plan.v_box;
      mbar_wait(&bar[1 + slot], (uint32_t)((j / kRing) & 1));
      if (mine) {
        const T* vd =
            reinterpret_cast<const T*>(smem + plan.off_v + slot * plan.v_pitch) +
            dl;
        const int n = min(plan.v_box, s_len - t0b);
#pragma unroll 8
        for (int t = 0; t < n; ++t)
          a = fma_acc(pg[t0b + t], to_float(vd[(size_t)t * dc]), a);
      }
      __syncthreads();  // every thread is done with the box
      if (threadIdx.x == 0 && j + kRing < n_boxes) {
        // the reads above before the copy engine's write into the box
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        load_box(j + kRing);
      }
    }
    if (mine) store(ob + (size_t)g * d_dim + dl, static_cast<float>(a));
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
    return;
  }
  mbar_wait(&bar[1], 0);
  for (int i = threadIdx.x; i < group * dc; i += kThreads) {
    const int g = i / dc, dl = i - g * dc;
    const float* pg = s_p + g * pitch;
    const T* vd = s_v + dl;
    typename Acc<T>::type a = 0;
#pragma unroll 8
    for (int t = 0; t < s_len; ++t)
      a = fma_acc(pg[t], to_float(vd[(size_t)t * dc]), a);
    store(ob + (size_t)g * d_dim + dl, static_cast<float>(a));
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* mask,
           void* out, int b_dim, int h_dim, int hkv, int d_dim, int s_len,
           int cs, float scale, cudaStream_t stream) {
  const int group = h_dim / hkv;
  if (group > kMaxGroup || cs < 1 || cs > kMaxCluster || (cs & (cs - 1)) ||
      !slices_ok(d_dim, cs, (int)sizeof(T)) || s_len < 1)
    return (int)cudaErrorInvalidValue;
  const Plan plan = make_plan(group, d_dim, s_len, cs, (int)sizeof(T));
  if (plan.total > kSmemMax || (plan.ring && group * plan.dc > kThreads))
    return (int)cudaErrorInvalidValue;
  const uint64_t dims[3] = {(uint64_t)d_dim, (uint64_t)hkv,
                            (uint64_t)b_dim * s_len};
  const uint64_t strides[2] = {(uint64_t)d_dim * sizeof(T),
                               (uint64_t)hkv * d_dim * sizeof(T)};
  const uint32_t box[3] = {(uint32_t)plan.dc, 1, (uint32_t)plan.v_box};
  CUtensorMap v_map;
  if (hopper::tensor_map_3d(v,
                            sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                           : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                            dims, strides, box, &v_map) != 0)
    return (int)cudaErrorInvalidValue;
  auto kernel = prefill_attention_kernel<T>;
  int set = 0;
  if (plan.total > 48 * 1024)
    set = hopper::func_attribute_at_least<
        prefill_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize>((int)plan.total);
  if (set == 0 && cs > 8)
    set = hopper::func_attribute_at_least<
        prefill_attention_kernel<T>,
        cudaFuncAttributeNonPortableClusterSizeAllowed>(1);
  if (set != 0) return set;
  cudaError_t err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs * hkv, b_dim, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = plan.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, v_map, static_cast<const T*>(q),
                           static_cast<const T*>(k), mask,
                           static_cast<T*>(out), h_dim, hkv, d_dim, s_len,
                           scale, plan);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v and out are bfloat16 when is_bf16 is nonzero, else float32, all
// 16-byte aligned.  `scale` must already be representable in that type.
// `cluster` CTAs share each (KV head, batch row): a power of two up to 16
// that divides D into column slices of a multiple of 16 bytes (for a long
// cache, also into at most kThreads / G columns).  Launches
// on `stream`; allocates nothing.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for what the kernel does not take.
int prefill_attention_launch(const void* q, const void* k, const void* v,
                             const int* mask, void* out, int b_dim, int h_dim,
                             int hkv, int d_dim, int s_len, int cluster,
                             float scale, int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, mask, out, b_dim, h_dim, hkv, d_dim,
                                 s_len, cluster, scale, s);
  return launch<float>(q, k, v, mask, out, b_dim, h_dim, hkv, d_dim, s_len,
                       cluster, scale, s);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
