// Matmul with a fused NL-ADC epilogue for sm_90a, dense and per expert.
//
// Replaces two TPU kernels:
//  * src/repro/kernels/fused_matmul_nladc.py::fused_matmul_nladc_pallas
//    (the dense LM's MLP gate and the MoE's shared-expert gate):
//
//      acc[m, n] = sum_k float(x[m, k]) * w[k, n]   (+ bias[n])     in float32
//      out[m, n] = y_table[#{j : acc[m, n] > thr[j]}]  rounded to x's type
//
//  * src/repro/kernels/ops.py::moe_fused_matmul, the same vmapped over the
//    experts (the MoE's routed-expert gate): out[e] = NLADC(x[e] @ w[e]),
//    one threshold set shared by every expert.  It has a kernel of its own
//    below (moe_gate_kernel): persistent CTAs that stream the experts'
//    weights through a TMA ring and skip the experts that hold no token.
//
// x is (M, K) or (E, C, K) float32 or bfloat16, w the (K, N) or (E, K, N)
// float32 master weights, thr one (P,) ramp for every column (stride 0) or
// one row of an (N, P) per-column matrix (stride P, the threshold-bank
// layout).  The comparator is strict, and the decode is a lookup in the
// ramp's y table, as the port's reference backend decodes.
//
// Both kernels sum in one fixed order: 16 partial sums, partial j over
// k = j, j + 16, j + 32, ... in increasing k, then the 16 partials added in
// the order j = 0, 1, ..., 15.  No launch config changes that order, so
// every config, of either kernel, computes the same bits.  Products and
// sums are written as __fmaf_rn / __fadd_rn so nvcc's --fmad choice cannot
// change the rounding.
//
// The dense gate.  Bound on this card: the LM's MLP gate (qwen2.5-3b,
// K 2048, N 11008) runs with M = 4 (a decode step) or M = 1 (a prefill
// step).  Each call then reads the 90.2 MB float32 weight once and does
// 2*M*K*N = 180 MFLOP, so it is bound by bytes: 27 us at 3.35 TB/s,
// against 2.7 us of float32 operations at 67 TFLOP/s.  Tensor cores would
// not help a GEMV.  The design streams w through the card once, with
// every load coalesced:
//
//   * a block owns 32 columns and kRows rows of x (by default 4); each of
//     its 16 warps walks its own share of K (rows k = warp, warp + 16,
//     ...), each lane reading one column of a weight row (one 128-byte
//     warp load per row, 16 rows loaded before their FMAs so their loads
//     are in flight together), so one block reads a 32-column strip of w
//     and the grid covers N with 344 blocks at N = 11008;
//   * x is staged in shared memory as float32, 512 columns of K at a
//     time by default, K-major (a k's kRows values side by side, so their
//     offsets are constants whatever the K tile), and read by broadcast;
//   * each thread keeps its kRows accumulators in registers; the 16 warps'
//     partial sums meet in shared memory and are added in warp order;
//   * the epilogue (bias, P compares, table lookup, round to nearest even)
//     runs on the float32 sum, one thread per output; a per-column
//     threshold strip is staged in shared memory with a padded stride so
//     the threads' row reads do not collide in one bank.
//
// Rows of x past M (the ragged edge) are staged as zeros and their outputs
// are not written.  Launch configs (kernels/tune.py): (rows, cols, tile_k)
// at run time: rows of x per block (1, 2, 4 or 8; template instances),
// columns per block (32 or 64: one or two per lane) and the K tile staged
// at a time (a power of two from 16 to 2048).
//
// The expert gate (moonshot-v1-16b-a3b: E 64, C 6, K 2048, N 1408).  Bound
// on this card: all 64 experts' 738 MB of float32 weight, 220 us at
// 3.35 TB/s against 33 us of operations.  At decode (B 4, top-6) at most
// 24 experts hold a token; the capacity rows of the others are zeros, and
// their weight need not be read.  The design (moe_gate_kernel):
//
//   * work items (expert, block of `rows` capacity rows, strip of `cols`
//     columns: 128 or 256, 512 B or 1 KB of each weight row), taken from
//     a work counter by one persistent CTA per SM (a cooperative launch);
//   * before any weight is read, each unit (expert, block of rows) has its
//     x rows checked by one CTA: where every element compares equal to 0
//     (-0.0 included: the dispatch buffer multiplies empty rows by 0) the
//     unit is empty, and the consumers write y_table[#{j : 0 > thr_j}] to
//     each output of its items.  For finite weights that is bitwise what
//     the sum gives: a sum of +-0 products is +-0, and the strict
//     comparator treats -0 as 0.  PRECONDITION: w is finite (an inf or
//     NaN weight would make a live sum NaN).  The skip is per unit: at the
//     default rows (8 >= C) an expert with one live row streams its whole
//     weight.  After a grid barrier every CTA hands out the live units'
//     items first, so their weight streams start at once, and the empty
//     items' output writes fill the tail;
//   * for a live item one producer warp copies its x rows (and, banked,
//     the strip's thresholds) into shared memory (bulk copies, double-
//     buffered across items) and streams the weight strip through a ring
//     of stages, each a TMA 3-D box of `tile_k` K rows by `cols` columns
//     with mbarrier completion, running as many stages ahead as fit (up
//     to 8);
//   * 16 consumer warps, warp j summing k = j, j + 16, ... of each stage
//     against the x rows (4 or 8 columns a lane), release each stage to the
//     producer; their partial sums meet in shared memory, are added in
//     warp order, and the epilogue is the dense gate's.  The bits are those
//     of the dense kernel run on each expert's slab.
//
// Launch configs for the expert gate (kernels/tune.py, resolved at the
// per-expert (C, K, N) key): (rows, cols, tile_k) = rows of x per item
// (1, 2, 4 or 8), columns per strip (128 or 256) and K rows per stage (16,
// 32 or 64).  It needs N a multiple of 4, K x (x's element size) a
// multiple of 16 bytes, and x, w and thr 16-byte aligned (the bulk
// copies').

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kWarps = 16;  // the K split: fixed, it sets the summation order
constexpr int kThreads = 32 * kWarps;
constexpr int kBatch = 16;  // weight rows a warp of the dense gate loads at once

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One block: columns n0 .. n0+kCols-1 and rows m0 .. m0+kRows-1 of the
// (M, K) @ (K, N) product.
template <typename T, int kRows, int kColsPerLane>
__global__ void __launch_bounds__(kThreads) fused_matmul_nladc_kernel(
    const T* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ thr,
    const float* __restrict__ y_table, T* __restrict__ out, int m_dim,
    int k_dim, int n_dim, int p, int thr_stride, int tile_k) {
  constexpr int kCols = 32 * kColsPerLane;
  extern __shared__ float smem[];
  const int thr_pitch = thr_stride ? p + 1 : p;
  float* s_x = smem;                                  // tile_k x kRows
  float* s_part = s_x + kRows * tile_k;               // kWarps x kRows x kCols
  float* s_thr = s_part + kWarps * kRows * kCols;     // kCols x (P+1), or P
  float* s_y = s_thr + (thr_stride ? kCols : 1) * thr_pitch;  // P + 1

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kCols;
  const int m0 = blockIdx.y * kRows;
  const int rows = min(kRows, m_dim - m0);
  const int log_tile = __ffs(tile_k) - 1;  // tile_k is a power of two

  float acc[kRows][kColsPerLane];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < k_dim; k0 += tile_k) {
    const int kt = min(tile_k, k_dim - k0);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < kRows * tile_k; i += kThreads) {
      const int r = i >> log_tile, kk = i & (tile_k - 1);
      s_x[kk * kRows + r] =
          (r < rows && kk < kt)
              ? to_float(x[(size_t)(m0 + r) * k_dim + k0 + kk])
              : 0.f;
    }
    __syncthreads();
    // kBatch weight rows at a time, every load issued before the batch's
    // FMAs, so kBatch loads a warp are in flight.  (Left to `#pragma
    // unroll`, how many nvcc kept in flight, 5 or 2, changed with
    // unrelated edits of this kernel, and its time by 55%.)  The FMAs keep
    // the order k = warp, warp + 16, ... of the summation contract.
    int kk = warp;
    for (; kk + (kBatch - 1) * kWarps < kt; kk += kBatch * kWarps) {
      float wv[kBatch][kColsPerLane];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const float* wrow = w + (size_t)(k0 + kk + u * kWarps) * n_dim;
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c) {
          const int n = n0 + lane + 32 * c;
          wv[u][c] = n < n_dim ? __ldg(wrow + n) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float xv = s_x[(kk + u * kWarps) * kRows + r];
#pragma unroll
          for (int c = 0; c < kColsPerLane; ++c)
            acc[r][c] = __fmaf_rn(xv, wv[u][c], acc[r][c]);
        }
    }
    for (; kk < kt; kk += kWarps) {
      const float* wrow = w + (size_t)(k0 + kk) * n_dim;
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) {
        const int n = n0 + lane + 32 * c;
        const float wv = n < n_dim ? __ldg(wrow + n) : 0.f;
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          acc[r][c] = __fmaf_rn(s_x[kk * kRows + r], wv, acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c)
      s_part[(warp * kRows + r) * kCols + lane + 32 * c] = acc[r][c];
  if (thr_stride) {
    // the block's columns n0 .. n0+kCols-1 are one contiguous strip of (N, P)
    const int n_here = min(kCols, n_dim - n0);
    for (int i = threadIdx.x; i < n_here * p; i += kThreads)
      s_thr[(i / p) * thr_pitch + i % p] = thr[(size_t)n0 * p + i];
  } else {
    for (int i = threadIdx.x; i < p; i += kThreads) s_thr[i] = thr[i];
  }
  for (int i = threadIdx.x; i <= p; i += kThreads) s_y[i] = y_table[i];
  __syncthreads();

  for (int i = threadIdx.x; i < kRows * kCols; i += kThreads) {
    const int r = i / kCols, col = i % kCols;
    const int n = n0 + col;
    if (r >= rows || n >= n_dim) continue;
    float s = s_part[r * kCols + col];
#pragma unroll
    for (int wi = 1; wi < kWarps; ++wi)
      s = __fadd_rn(s, s_part[(wi * kRows + r) * kCols + col]);
    if (bias != nullptr) s = __fadd_rn(s, bias[n]);
    const float* t = thr_stride ? s_thr + col * thr_pitch : s_thr;
    int count = 0;
    for (int j = 0; j < p; ++j) count += (s > t[j]) ? 1 : 0;
    store(out + (size_t)(m0 + r) * n_dim + n, s_y[count]);
  }
}

template <typename T, int kRows, int kColsPerLane>
int launch(const void* x, const float* w, const float* bias,
           const float* thr, const float* y_table, void* out, int m_dim,
           int k_dim, int n_dim, int p, int thr_stride, int tile_k,
           cudaStream_t stream) {
  constexpr int kCols = 32 * kColsPerLane;
  const int thr_pitch = thr_stride ? p + 1 : p;
  const size_t smem =
      sizeof(float) * ((size_t)kRows * tile_k + (size_t)kWarps * kRows * kCols +
                       (size_t)(thr_stride ? kCols : 1) * thr_pitch + p + 1);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_matmul_nladc_kernel<T, kRows, kColsPerLane>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((n_dim + kCols - 1) / kCols, (m_dim + kRows - 1) / kRows);
  fused_matmul_nladc_kernel<T, kRows, kColsPerLane>
      <<<grid, kThreads, smem, stream>>>(
          static_cast<const T*>(x), w, bias, thr, y_table,
          static_cast<T*>(out), m_dim, k_dim, n_dim, p, thr_stride, tile_k);
  return (int)cudaGetLastError();
}

// The template instance of a (rows, cols) config; tile_k a power of two
// from 16 to 2048.  An unsupported config returns cudaErrorInvalidValue.
template <typename T>
int dispatch(const void* x, const float* w, const float* bias,
             const float* thr, const float* y_table, void* out, int m_dim,
             int k_dim, int n_dim, int p, int thr_stride, int rows, int cols,
             int tile_k, cudaStream_t stream) {
  if (tile_k < 16 || tile_k > 2048 || (tile_k & (tile_k - 1)))
    return (int)cudaErrorInvalidValue;
#define FMN_CASE(R, C)                                                      \
  if (rows == R && cols == 32 * C)                                          \
    return launch<T, R, C>(x, w, bias, thr, y_table, out, m_dim, k_dim,    \
                           n_dim, p, thr_stride, tile_k, stream);
  FMN_CASE(1, 1) FMN_CASE(2, 1) FMN_CASE(4, 1) FMN_CASE(8, 1)
  FMN_CASE(1, 2) FMN_CASE(2, 2) FMN_CASE(4, 2) FMN_CASE(8, 2)
#undef FMN_CASE
  return (int)cudaErrorInvalidValue;
}


// ---------------------------------------------------------------------------
// The grouped expert gate
// ---------------------------------------------------------------------------

constexpr int kGateWarps = kWarps;                   // consumers: the K split
constexpr int kGateThreads = 32 * (kGateWarps + 1);  // + one producer warp
constexpr int kGateConsumers = 32 * kGateWarps;
constexpr int kGateMaxStages = 8;
constexpr int kInfoSlots = 4;   // items the producer may run ahead
constexpr int kPartOutputs = 256;  // outputs a partial-sum round covers
constexpr size_t kSmemMax = 232448;

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kGateConsumers) : "memory");
}

// #{j : s > t[j]}, the strict comparator.  A count is the same in any
// order, so where the lanes of a warp read P-long rows of their own, an even
// P starts each lane at j = lane mod P: rows P floats apart would otherwise
// put every lane's t[j] in one shared-memory bank (32-way at P 32).
__device__ __forceinline__ int count_above(float s, const float* t, int p,
                                           int start) {
  int count = 0, j = start;
#pragma unroll 8
  for (int q = 0; q < p; ++q) {
    count += (s > t[j]) ? 1 : 0;
    j = j + 1 == p ? 0 : j + 1;
  }
  return count;
}

// The expert gate's work items and shared-memory layout, in bytes
// (kernels/fused_matmul_nladc.py::expert_gate_stages mirrors it).
struct GatePlan {
  int stages;               // ring stages
  int n_rb, n_strips, n_units, n_items;
  size_t off_thr, off_code, off_units, off_part, off_x, x_slot, off_tslot,
      t_slot, off_ring, stage_bytes, total;
};

inline size_t align128(size_t v) {
  return (v + 127) & ~static_cast<size_t>(127);
}

inline GatePlan gate_plan(int rows, int cols, int k_tile, int e_dim,
                          int c_dim, int k_dim, int n_dim, int p, bool banked,
                          int elem) {
  GatePlan g;
  const int r2 = (kPartOutputs / cols < rows) ? kPartOutputs / cols : rows;
  g.n_rb = (c_dim + rows - 1) / rows;
  g.n_strips = (n_dim + cols - 1) / cols;
  g.n_units = e_dim * g.n_rb;
  g.n_items = g.n_units * g.n_strips;
  g.off_thr = 256;  // barriers and the item records first
  g.off_code = align128(g.off_thr + 4 * (size_t)(2 * p + 1));
  g.off_units = align128(g.off_code + 4 * (size_t)cols);
  g.off_part = align128(g.off_units + 4 * (size_t)g.n_units);
  g.off_x = align128(g.off_part + 4 * (size_t)kGateWarps * r2 * cols);
  g.x_slot = align128((size_t)rows * k_dim * elem);
  g.off_tslot = g.off_x + 2 * g.x_slot;
  g.t_slot = banked ? align128(4 * (size_t)cols * p) : 0;
  g.off_ring = g.off_tslot + 2 * g.t_slot;
  g.stage_bytes = 4 * (size_t)k_tile * cols;
  const size_t room = kSmemMax > g.off_ring ? kSmemMax - g.off_ring : 0;
  g.stages = (int)(room / g.stage_bytes);
  if (g.stages > kGateMaxStages) g.stages = kGateMaxStages;
  g.total = g.off_ring + (size_t)g.stages * g.stage_bytes;
  return g;
}

// w_map: the weights as (N, K, E), a box of kNS columns by k_tile K rows.
// work: 3 + n_units ints; the first three are 0 before the launch and
// again after it (the last CTA to finish resets them): the next work
// item, the CTAs done, the CTAs past the grid barrier; then one liveness
// flag per unit (expert, block of kRows capacity rows).  The launch is
// cooperative: every CTA is resident, so the grid barrier cannot hang.
template <typename T, int kRows, int kCpl>
__global__ void __launch_bounds__(kGateThreads, 1) moe_gate_kernel(
    const __grid_constant__ CUtensorMap w_map, const T* __restrict__ x,
    const float* __restrict__ thr, const float* __restrict__ y_table,
    T* __restrict__ out, int* __restrict__ work, int c_dim, int k_dim,
    int n_dim, int p, int thr_stride, int k_tile, GatePlan plan) {
  using hopper::mbar_arrive;
  using hopper::mbar_expect_tx;
  using hopper::mbar_init;
  using hopper::mbar_wait;
  constexpr int kNS = 32 * kCpl;  // columns of a strip
  constexpr int kR2 = (kPartOutputs / kNS < kRows) ? kPartOutputs / kNS
                                                   : kRows;
  // (the dense kernel declares the dynamic shared memory as float)
  extern __shared__ __align__(128) unsigned char gate_smem[];
  unsigned char* smem = gate_smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // stage loaded
  uint64_t* empty = full + kGateMaxStages;             // stage consumed
  uint64_t* info_full = empty + kGateMaxStages;        // item record ready
  uint64_t* info_empty = info_full + kInfoSlots;       // item record read
  uint64_t* x_empty = info_empty + kInfoSlots;         // x slot consumed
  int* info_item = reinterpret_cast<int*>(x_empty + 2);  // item, -1: done
  int* info_flag = info_item + kInfoSlots;             // live | x slot << 1
  float* s_thr = reinterpret_cast<float*>(smem + plan.off_thr);  // P (flat)
  float* s_y = s_thr + p;                                        // P + 1
  int* s_code = reinterpret_cast<int*>(smem + plan.off_code);    // kNS
  int* s_units = reinterpret_cast<int*>(smem + plan.off_units);  // live, then
                                                                 // empty
  float* s_part = reinterpret_cast<float*>(smem + plan.off_part);
  unsigned char* s_x = smem + plan.off_x;
  unsigned char* s_t = smem + plan.off_tslot;  // banked: a strip's (kNS, P)
  unsigned char* s_ring = smem + plan.off_ring;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < plan.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kGateWarps);
    }
    for (int i = 0; i < kInfoSlots; ++i) {
      mbar_init(&info_full[i], 1);
      mbar_init(&info_empty[i], kGateWarps);
    }
    mbar_init(&x_empty[0], kGateWarps);
    mbar_init(&x_empty[1], kGateWarps);
    hopper::fence_mbar_init();
  }
  if (!thr_stride)
    for (int i = threadIdx.x; i < p; i += kGateThreads) s_thr[i] = thr[i];
  for (int i = threadIdx.x; i <= p; i += kGateThreads) s_y[i] = y_table[i];

  // Before any weight is read, each unit's x rows are checked by one CTA:
  // live if an element compares unequal to 0 (the sign bit is ignored:
  // -0 == 0).  Then a grid barrier, after which every flag is written.
  int* flags = work + 3;
  constexpr uint32_t kMag = sizeof(T) == 2 ? 0x7fff7fffu : 0x7fffffffu;
  for (int u = blockIdx.x; u < plan.n_units; u += gridDim.x) {
    const int e = u / plan.n_rb, r0 = (u % plan.n_rb) * kRows;
    const uint4* v = reinterpret_cast<const uint4*>(
        x + ((size_t)e * c_dim + r0) * k_dim);
    const uint32_t n16 =
        (uint32_t)((size_t)min(kRows, c_dim - r0) * k_dim * sizeof(T) / 16);
    uint32_t bits = 0;
#pragma unroll 4
    for (uint32_t i = threadIdx.x; i < n16; i += kGateThreads) {
      const uint4 a = __ldg(v + i);
      bits |= (a.x | a.y | a.z | a.w) & kMag;
    }
    const int live = __syncthreads_or(bits != 0);
    if (threadIdx.x == 0) flags[u] = live;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(&work[2], 1);
    while (*reinterpret_cast<volatile int*>(&work[2]) < (int)gridDim.x)
      __nanosleep(64);
    __threadfence();
  }
  __syncthreads();

  if (warp == kGateWarps) {
    // the producer: the live units, then the empty ones, in unit order
    int n_live_units = 0, n_empty_units = 0;
    for (int base = 0; base < plan.n_units; base += 32) {
      const int u = base + lane;
      const int f = u < plan.n_units ? __ldcg(&flags[u]) : -1;
      const uint32_t lv = __ballot_sync(0xffffffffu, f == 1);
      const uint32_t em = __ballot_sync(0xffffffffu, f == 0);
      const uint32_t below = (1u << lane) - 1;
      if (f == 1) s_units[n_live_units + __popc(lv & below)] = u;
      if (f == 0)
        s_units[plan.n_units - 1 - (n_empty_units + __popc(em & below))] = u;
      n_live_units += __popc(lv);
      n_empty_units += __popc(em);
    }
    __syncwarp();
    // takes the next item (every strip of the live units first), and for a
    // live item copies its x rows (and banked thresholds) and streams its
    // weight strip through the ring
    const int n_live_items = n_live_units * plan.n_strips;
    int stage = 0, n_live = 0;
    uint32_t phase = 0;
    for (int j = 0;; ++j) {
      int next = lane == 0 ? atomicAdd(&work[0], 1) : 0;
      next = __shfl_sync(0xffffffffu, next, 0);
      const bool done = next >= plan.n_items;
      const bool live = !done && next < n_live_items;
      int unit = 0, strip = 0;
      if (live) {
        unit = s_units[next / plan.n_strips];
        strip = next % plan.n_strips;
      } else if (!done) {  // the empty units sit at the end, reversed
        const int q = next - n_live_items;
        unit = s_units[plan.n_units - 1 - q / plan.n_strips];
        strip = q % plan.n_strips;
      }
      const int item = unit * plan.n_strips + strip;
      const int e = unit / plan.n_rb, r0 = (unit % plan.n_rb) * kRows;
      const int rows = min(kRows, c_dim - r0);
      const int n0 = strip * kNS, cols = min(kNS, n_dim - n0);
      const T* xe = x + ((size_t)e * c_dim + r0) * k_dim;
      const uint32_t x_bytes = (uint32_t)((size_t)rows * k_dim * sizeof(T));
      const int slot = j % kInfoSlots;
      if (lane == 0) {
        if (j >= kInfoSlots)
          mbar_wait(&info_empty[slot], ((j / kInfoSlots) - 1) & 1);
        info_item[slot] = done ? -1 : item;
        if (live) {
          const int xs = n_live & 1;
          if (n_live >= 2) mbar_wait(&x_empty[xs], ((n_live >> 1) - 1) & 1);
          info_flag[slot] = 1 | (xs << 1);
          const uint32_t t_bytes =
              thr_stride ? (uint32_t)(4 * cols * thr_stride) : 0;
          mbar_expect_tx(&info_full[slot], x_bytes + t_bytes);
          hopper::bulk_load(s_x + xs * plan.x_slot, xe, x_bytes,
                            &info_full[slot]);
          if (thr_stride)
            hopper::bulk_load(s_t + xs * plan.t_slot,
                              thr + (size_t)n0 * thr_stride, t_bytes,
                              &info_full[slot]);
          for (int k0 = 0; k0 < k_dim; k0 += k_tile) {
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_expect_tx(&full[stage], (uint32_t)plan.stage_bytes);
            hopper::tma_load_3d(s_ring + stage * plan.stage_bytes, &w_map, n0,
                                k0, e, &full[stage]);
            if (++stage == plan.stages) {
              stage = 0;
              phase ^= 1;
            }
          }
        } else {
          info_flag[slot] = 0;
          mbar_arrive(&info_full[slot]);
        }
      }
      if (live) ++n_live;
      __syncwarp();
      if (done) break;
    }
    // the last CTA out resets the counters for the next launch
    if (lane == 0) {
      __threadfence();
      if (atomicAdd(&work[1], 1) == (int)gridDim.x - 1) {
        work[0] = 0;
        work[1] = 0;
        work[2] = 0;
      }
    }
    return;
  }

  // the consumers
  int stage = 0;
  uint32_t phase = 0;
  for (int j = 0;; ++j) {
    const int slot = j % kInfoSlots;
    mbar_wait(&info_full[slot], (j / kInfoSlots) & 1);
    const int item = info_item[slot], rec = info_flag[slot];
    __syncwarp();
    if (lane == 0) mbar_arrive(&info_empty[slot]);
    if (item < 0) break;
    const int strip = item % plan.n_strips;
    const int er = item / plan.n_strips;
    const int e = er / plan.n_rb, r0 = (er % plan.n_rb) * kRows;
    const int rows = min(kRows, c_dim - r0);
    const int n0 = strip * kNS;
    T* oe = out + ((size_t)e * c_dim + r0) * n_dim;

    if (!(rec & 1)) {
      // an empty item: every sum is +-0, one code a column, counted by a
      // warp (a lane a threshold, coalesced)
      consumers_sync();  // s_code's last readers are done
      for (int col = warp; col < kNS && n0 + col < n_dim; col += kGateWarps) {
        const float* t =
            thr_stride ? thr + (size_t)(n0 + col) * thr_stride : s_thr;
        int count = 0;
        for (int q0 = 0; q0 < p; q0 += 32) {
          const int q = q0 + lane;
          count += __popc(__ballot_sync(0xffffffffu, q < p && 0.f > t[q]));
        }
        if (lane == 0) s_code[col] = count;
      }
      consumers_sync();
      for (int i = threadIdx.x; i < rows * kNS; i += kGateConsumers) {
        const int r = i / kNS, col = i % kNS;
        if (n0 + col < n_dim)
          store(oe + (size_t)r * n_dim + n0 + col, s_y[s_code[col]]);
      }
      continue;
    }

    const int xs = rec >> 1;
    const T* xr = reinterpret_cast<const T*>(s_x + xs * plan.x_slot);
    const float* t_strip =
        reinterpret_cast<const float*>(s_t + xs * plan.t_slot);
    float acc[kRows][kCpl];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCpl; ++c) acc[r][c] = 0.f;
    for (int k0 = 0; k0 < k_dim; k0 += k_tile) {
      mbar_wait(&full[stage], phase);
      const float* st =
          reinterpret_cast<const float*>(s_ring + stage * plan.stage_bytes);
      const int kv = min(k_tile, k_dim - k0);
      for (int kk = warp; kk < kv; kk += kGateWarps) {
        float wv[kCpl];
#pragma unroll
        for (int h = 0; h < kCpl / 4; ++h) {
          const float4 a = *reinterpret_cast<const float4*>(
              st + kk * kNS + h * 128 + lane * 4);
          wv[4 * h] = a.x;
          wv[4 * h + 1] = a.y;
          wv[4 * h + 2] = a.z;
          wv[4 * h + 3] = a.w;
        }
        const T* xk = xr + k0 + kk;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float xv = to_float(xk[(size_t)r * k_dim]);
#pragma unroll
          for (int c = 0; c < kCpl; ++c)
            acc[r][c] = __fmaf_rn(xv, wv[c], acc[r][c]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == plan.stages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // the 16 partial sums meet in shared memory, kR2 rows at a time, and
    // are added in warp order; then the epilogue, one thread per output
#pragma unroll
    for (int rc = 0; rc < kRows; rc += kR2) {
#pragma unroll
      for (int rr = 0; rr < kR2; ++rr)
#pragma unroll
        for (int c = 0; c < kCpl; ++c)
          s_part[(warp * kR2 + rr) * kNS + (c / 4) * 128 + lane * 4 + c % 4] =
              acc[rc + rr][c];
      consumers_sync();
      if (threadIdx.x < kR2 * kNS) {
        const int rr = threadIdx.x / kNS, col = threadIdx.x % kNS;
        const int r = rc + rr, n = n0 + col;
        if (r < rows && n < n_dim) {
          float s = s_part[rr * kNS + col];
#pragma unroll
          for (int wi = 1; wi < kGateWarps; ++wi)
            s = __fadd_rn(s, s_part[(wi * kR2 + rr) * kNS + col]);
          const float* t = thr_stride ? t_strip + col * thr_stride : s_thr;
          const int start = (thr_stride && !(p & 1)) ? lane % p : 0;
          store(oe + (size_t)r * n_dim + n, s_y[count_above(s, t, p, start)]);
        }
      }
      consumers_sync();
    }
    // x slot and threshold strip consumed
    if (lane == 0) mbar_arrive(&x_empty[xs]);
  }
}

template <typename T, int kRows, int kCpl>
int gate_launch(const void* x, const float* w, const float* thr,
                const float* y_table, void* out, int* work, int e_dim,
                int c_dim, int k_dim, int n_dim, int p, int thr_stride,
                int k_tile, cudaStream_t stream) {
  constexpr int kNS = 32 * kCpl;
  if (k_tile < 16 || k_tile > 64 || k_tile % 16 || n_dim % 4 ||
      ((size_t)k_dim * sizeof(T)) % 16 ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(thr) % 16)
    return (int)cudaErrorInvalidValue;
  const GatePlan plan = gate_plan(kRows, kNS, k_tile, e_dim, c_dim, k_dim,
                                  n_dim, p, thr_stride != 0, (int)sizeof(T));
  if (plan.stages < 2) return (int)cudaErrorInvalidValue;
  const int kk = k_dim > 0 ? k_dim : 1;  // K = 0: every item is empty
  const uint64_t dims[3] = {(uint64_t)n_dim, (uint64_t)kk, (uint64_t)e_dim};
  const uint64_t strides[2] = {(uint64_t)n_dim * 4, (uint64_t)kk * n_dim * 4};
  const uint32_t box[3] = {(uint32_t)kNS, (uint32_t)k_tile, 1};
  CUtensorMap map;
  if (hopper::tensor_map_3d(w, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, dims, strides,
                            box, &map) != 0)
    return (int)cudaErrorInvalidValue;
  auto kernel = moe_gate_kernel<T, kRows, kCpl>;
  const int set = hopper::func_attribute_at_least<
      moe_gate_kernel<T, kRows, kCpl>,
      cudaFuncAttributeMaxDynamicSharedMemorySize>((int)plan.total);
  if (set != 0) return set;
  const int sms = hopper::sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(plan.n_items < sms ? plan.n_items : sms, 1, 1);
  cfg.blockDim = dim3(kGateThreads, 1, 1);
  cfg.dynamicSmemBytes = plan.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;  // the grid barrier
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, map, static_cast<const T*>(x), thr,
                           y_table, static_cast<T*>(out), work, c_dim, k_dim,
                           n_dim, p, thr_stride, k_tile, plan);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The template instance of an expert-gate config (rows, cols, k_tile).
template <typename T>
int gate_dispatch(const void* x, const float* w, const float* thr,
                  const float* y_table, void* out, int* work, int e_dim,
                  int c_dim, int k_dim, int n_dim, int p, int thr_stride,
                  int rows, int cols, int k_tile, cudaStream_t stream) {
#define GATE_CASE(R, C)                                                    \
  if (rows == R && cols == 32 * C)                                         \
    return gate_launch<T, R, C>(x, w, thr, y_table, out, work, e_dim,      \
                                c_dim, k_dim, n_dim, p, thr_stride, k_tile, \
                                stream);
  GATE_CASE(1, 4) GATE_CASE(2, 4) GATE_CASE(4, 4) GATE_CASE(8, 4)
  GATE_CASE(1, 8) GATE_CASE(2, 8) GATE_CASE(4, 8) GATE_CASE(8, 8)
#undef GATE_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x and out are bfloat16 when x_bf16 is nonzero, else float32.  bias may
// be null.  (rows, cols, tile_k) is the launch config.  Launches on
// `stream`; allocates nothing.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a config without a template instance.
int fused_matmul_nladc_launch(const void* x, const float* w,
                              const float* bias, const float* thr,
                              const float* y_table, void* out, int m_dim,
                              int k_dim, int n_dim, int p, int thr_stride,
                              int x_bf16, int rows, int cols, int tile_k,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16)
    return dispatch<__nv_bfloat16>(x, w, bias, thr, y_table, out, m_dim,
                                   k_dim, n_dim, p, thr_stride, rows, cols,
                                   tile_k, s);
  return dispatch<float>(x, w, bias, thr, y_table, out, m_dim, k_dim, n_dim,
                         p, thr_stride, rows, cols, tile_k, s);
}

// The expert gate: x (E, C, K), w (E, K, N), out (E, C, N), one threshold
// set for every expert, no bias; moe_gate_kernel with the config (rows,
// cols, tile_k) of the expert gate.  `work` is 3 + E x ceil(C / rows) ints
// of device memory, private to the stream, whose first three are zero
// before the launch (the kernel leaves them zero).  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a config or shape the
// kernel does not take.
int moe_fused_matmul_launch(const void* x, const float* w, const float* thr,
                            const float* y_table, void* out, int* work,
                            int n_experts, int c_dim, int k_dim, int n_dim,
                            int p, int thr_stride, int x_bf16, int rows,
                            int cols, int tile_k, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16)
    return gate_dispatch<__nv_bfloat16>(x, w, thr, y_table, out, work,
                                        n_experts, c_dim, k_dim, n_dim, p,
                                        thr_stride, rows, cols, tile_k, s);
  return gate_dispatch<float>(x, w, thr, y_table, out, work, n_experts, c_dim,
                              k_dim, n_dim, p, thr_stride, rows, cols, tile_k,
                              s);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
