// Matmul with a fused NL-ADC epilogue for sm_90a, dense and per expert.
//
// Replaces two TPU kernels:
//  * src/repro/kernels/fused_matmul_nladc.py::fused_matmul_nladc_pallas
//    (the dense LM's MLP gate and the MoE's shared-expert gate):
//
//      acc[m, n] = sum_k float(x[m, k]) * w[k, n]   (+ bias[n])     in float32
//      out[m, n] = y_table[#{j : acc[m, n] > thr[j]}]  rounded to x's type
//
//    It has two kernels here, picked by M alone (M <= 8: the GEMV, M > 8:
//    the GEMM; the wrapper's constant, no launch config picks).
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
// The contract (kernels/fused_matmul_nladc.py::code_flips): codes equal
// the float32 reference's except where the float64 accumulator lies within
// (K+1) 2^-24 (sum |x w| + |b|) of a crossed threshold.  Each kernel sums
// every output in one fixed order that no launch config changes, so every
// config computes the same bits.
//
// The GEMV (M <= 8; fused_matmul_nladc_kernel) and the expert gate sum in
// 16 partial sums, partial j over k = j, j + 16, j + 32, ... in increasing
// k, then the 16 partials added in the order j = 0, 1, ..., 15, with
// __fmaf_rn / __fadd_rn so nvcc's --fmad choice cannot change the
// rounding: IEEE round-to-nearest sums, for which the bound above is
// proven.
//
// The GEMV.  Bound on this card: the LM's MLP gate (qwen2.5-3b, K 2048,
// N 11008) serves with M = 4 (a decode step) or M = 1 (a prefill step).
// Each call then reads the 90.2 MB float32 weight once and does
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
// The GEMM (M > 8; fused_gemm_nladc_kernel).  The LM trains with M = B x S
// = 1024: at (1024, 2048, 11008) the GEMV would read w once per 4 rows
// (23 GB a call).  The float32 product is 46.2 GFLOP, 0.694 ms at the
// CUDA cores' 67 TFLOP/s (a SIMT GEMM's bound), and a tensor-core route
// must keep its float32 result:
//
//   * w is split on the card, from the float32 master weight at every
//     call (hopper.cuh::split3_pair), into three bfloat16 parts w1 + w2 +
//     w3 = w exactly (|w| >= 2^-110); bfloat16 x is one part, float32 x
//     splits as w does.  Every product of two parts is exact in float32,
//     so 3 (or 9) bfloat16 wgmma products make each multiply-add:
//     3 x 46.2 GFLOP = 0.140 ms at 989 TFLOP/s, the bound at the training
//     shape (bytes 0.035 ms: x 4.2 MB, w 90.2 MB, out 22.5 MB);
//   * the product is computed transposed, out^T = w^T x^T: the split w is
//     wgmma's register-sourced A operand (split by the consumer threads
//     from float32 tiles in shared memory, no bfloat16 copy of w is ever
//     stored), x's parts the K-major B operand in shared memory, so a
//     tile's accumulator row is one output column and a thread's banked
//     thresholds are two columns' strips;
//   * one producer warp streams every stage (64 K rows: w as 32-column
//     float32 boxes, x's parts as rows x 64 bfloat16, both 2-D TMA boxes
//     with the 128-byte swizzle) through a ring of up to 4 stages with
//     mbarrier completion; one or two consumer warpgroups (64 output
//     columns each) issue wgmma.mma_async; one persistent CTA per SM walks
//     the tiles, x rows fastest, so the CTAs in flight share a w strip in
//     L2 and a tile's epilogue overlaps the producer's next loads;
//   * summation: every 32 K rows (kPromoteSteps 16-row steps, each step's
//     3 (or 9) products smallest parts first) are summed on the tensor
//     cores from zero, then added to a float32 register sum with
//     __fadd_rn, in increasing K.  The tensor cores' own accumulation is
//     not documented as IEEE round-to-nearest, so the bound above holds
//     here by measurement, not by proof: at the training shape no flip has
//     fallen outside it (chip_smoke.py's fused_matmul phase counts them;
//     a flip outside it fails the run).  Summing all of K on the tensor
//     cores flipped ten times as many codes;
//   * the epilogue runs from the accumulator registers: bias (__fadd_rn),
//     the strict count (one set.gt a compare) against the thread's two
//     columns' thresholds (a banked strip of 64 columns staged in shared
//     memory by one bulk copy per tile; an even P starts lane group q at
//     threshold q so the groups' rows spread over the banks, as
//     count_above's rotated start), the y table lookup, and the rounded
//     pair stored per output row;
//   * ragged M, N and K: TMA fills rows and columns past the edge with
//     zeros, and no output past M or N is stored.  bfloat16 x goes to TMA
//     as it is where K x 2 bytes is a multiple of 16 and x is 16-byte
//     aligned; else (and for float32 x) a first launch writes its parts,
//     K padded to a multiple of 8, to the wrapper's scratch.  Needs N a
//     multiple of 4 and w 16-byte aligned (the TMA map's row pitch).
//
// Launch configs (kernels/tune.py, the M > 8 space): (rows, cols, stages)
// = x rows a tile (64 or 128: the wgmma N), output columns a tile (64 or
// 128: one or two consumer warpgroups) and the ring depth at most (2, 3
// or 4; as many run as fit in 227 KB).  Two accumulator sets of rows / 2
// floats a thread (the float32 sum and the tensor cores' step sum) are
// why a tile holds at most 128 rows.
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
//     warp order, and the epilogue is the GEMV's.  Its bits are those of
//     the GEMV run on each expert's slab (the GEMV's summation order at
//     any C; the dense gate takes the GEMM above C = 8, the expert gate
//     never).
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
#include <string.h>

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
// The dense gate for M > 8: a tensor-core GEMM over the split weight
// ---------------------------------------------------------------------------

// D = A * B + (scale_d ? D : 0) on the tensor cores, for one warpgroup:
// A the 64 x 16 bfloat16 tile in registers (four bf16x2 words a thread in
// wgmma's register layout: rows lane/4 and lane/4 + 8 of the warp's 16, K
// columns 2 (lane % 4) + {0, 1} and + 8), B the K-major 16 x kN bfloat16
// tile in shared memory at descriptor `desc`, D the 64 x kN float32
// accumulator, kN / 2 floats a thread (d[4 j + 2 h + c]: row lane/4 + 8 h
// of the warp's 16, column 8 j + 2 (lane % 4) + c).
template <int kN>
struct WgmmaRS;

template <>
struct WgmmaRS<64> {
  static __device__ __forceinline__ void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct WgmmaRS<128> {
  static __device__ __forceinline__ void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};


constexpr int kTileK = 64;     // K rows a ring stage: one 128-byte row of bf16 x
constexpr int kWgCols = 64;    // output columns a consumer warpgroup owns
constexpr int kBoxCols = 32;   // columns of a w box: 32 float32, 128 bytes
constexpr int kBoxBytes = kTileK * 128;
constexpr int kTcMaxStages = 4;
constexpr size_t kTcSmemMax = 232448;
// 16-row K steps the tensor cores sum before one float32 add: a kernel
// constant (it sets the summation order)
constexpr int kPromoteSteps = 2;
static_assert((kTileK / 16) % kPromoteSteps == 0,
              "a ring stage holds whole promotion intervals");

// x's bfloat16 parts as TMA sees them: one 2-D map a part
struct XMaps {
  CUtensorMap part[3];
};

// The GEMM's tiles and shared-memory layout, in bytes from the 1024-aligned
// base (kernels/fused_matmul_nladc.py::gemm_stages mirrors it): barriers,
// the y table, the flat thresholds, one banked threshold strip per
// consumer warpgroup, then the ring, each stage the w boxes then the x
// parts' tiles.
struct TcPlan {
  int stages, m_tiles, n_tiles, tiles;
  uint32_t off_y, off_thr, off_strip, strip_floats, off_ring, w_bytes,
      x_bytes, stage_bytes;
  size_t total;  // + 1024 bytes of slack to align the base
};

inline uint32_t align_up(uint32_t v, uint32_t a) { return (v + a - 1) / a * a; }

inline TcPlan tc_plan(int rows, int wgs, int parts, int stages_cap, int m_dim,
                      int n_dim, int p, bool banked) {
  TcPlan t;
  t.m_tiles = (m_dim + rows - 1) / rows;
  t.n_tiles = (n_dim + kWgCols * wgs - 1) / (kWgCols * wgs);
  t.tiles = t.m_tiles * t.n_tiles;
  t.off_y = 128;  // full[4], empty[4], strip[2] barriers first
  t.off_thr = align_up(t.off_y + 4u * (p + 1), 16);
  t.off_strip = align_up(t.off_thr + 4u * p, 16);
  t.strip_floats = banked ? (uint32_t)(kWgCols * p) : 0u;
  t.off_ring = align_up(t.off_strip + 4u * wgs * t.strip_floats, 1024);
  t.w_bytes = (uint32_t)(wgs * 2 * kBoxBytes);
  t.x_bytes = (uint32_t)(rows * 128);
  t.stage_bytes = t.w_bytes + parts * t.x_bytes;
  const size_t used = (size_t)t.off_ring + 1024;
  const size_t room = kTcSmemMax > used ? kTcSmemMax - used : 0;
  t.stages = (int)(room / t.stage_bytes);
  if (t.stages > stages_cap) t.stages = stages_cap;
  t.total = (size_t)t.off_ring + (size_t)t.stages * t.stage_bytes + 1024;
  return t;
}

// outputs n and n + 1 of a row (n even and N a multiple of 4: both lie
// inside the row or neither does)
__device__ __forceinline__ void store_pair(float* row, int n, float y0,
                                           float y1) {
  *reinterpret_cast<float2*>(row + n) = make_float2(y0, y1);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* row, int n,
                                           float y0, float y1) {
  *reinterpret_cast<__nv_bfloat162*>(row + n) = __floats2bfloat162_rn(y0, y1);
}

// A thread's 8 w values of a 16-row step (rows 2t, 2t + 1, 2t + 8, 2t + 9
// at byte offsets r0, r1 (+1024) of the step's 16 rows, each a float2 of
// two adjacent columns), split into three parts of four bf16x2 words in
// wgmma's A register layout
__device__ __forceinline__ void split_w_step(const unsigned char* wk,
                                             uint32_t r0, uint32_t r1,
                                             uint32_t (&a)[3][4]) {
  const float2 v0 = *reinterpret_cast<const float2*>(wk + r0);
  const float2 v1 = *reinterpret_cast<const float2*>(wk + r1);
  const float2 v2 = *reinterpret_cast<const float2*>(wk + 1024 + r0);
  const float2 v3 = *reinterpret_cast<const float2*>(wk + 1024 + r1);
  hopper::split3_pair(v0.x, v1.x, a[0][0], a[1][0], a[2][0]);
  hopper::split3_pair(v0.y, v1.y, a[0][1], a[1][1], a[2][1]);
  hopper::split3_pair(v2.x, v3.x, a[0][2], a[1][2], a[2][2]);
  hopper::split3_pair(v2.y, v3.y, a[0][3], a[1][3], a[2][3]);
}

// One persistent CTA per SM walks the (x rows, output columns) tiles, x
// rows fastest, so the CTAs in flight share a w strip in L2.  Warps
// 0 .. 4 kWgs - 1 are the consumer warpgroups, warp 4 kWgs the producer.
// The product is computed transposed, out^T = w^T x^T: warpgroup g's
// wgmma A operand is the split w (64 columns by 16 K rows, from float32
// tiles in shared memory into registers), its B operand a bf16 x part's
// K-major tile, its 64 x kRows accumulator one output column a row.  A
// warp's 16 A rows are the permuted columns 2 (r % 8) + r / 8, so a
// thread's two rows are adjacent columns: its float2 loads of w and its
// output stores are pairs.
template <typename T, int kRows, int kWgs>
__global__ void __launch_bounds__(128 * kWgs + 32, 1) fused_gemm_nladc_kernel(
    const __grid_constant__ CUtensorMap w_map,
    const __grid_constant__ XMaps x_maps, const float* __restrict__ bias,
    const float* __restrict__ thr, const float* __restrict__ y_table,
    T* __restrict__ out, int m_dim, int k_dim, int n_dim, int p,
    int thr_stride, TcPlan plan) {
  using hopper::mbar_arrive;
  using hopper::mbar_expect_tx;
  using hopper::mbar_init;
  using hopper::mbar_wait;
  constexpr int kParts = sizeof(T) == 4 ? 3 : 1;  // x's bf16 parts
  constexpr int kCols = kWgCols * kWgs;
  constexpr int kAcc = kRows / 2;
  // the products of a 16-row step, smallest first: (w part i, x part j)
  // by i + j descending (part i holds bits 8 i .. 8 i + 7 below the top):
  // with three x parts (2,2) (2,1) (1,2) (2,0) (1,1) (0,2) (1,0) (0,1)
  // (0,0), two bits an entry; with one, (2,0) (1,0) (0,0)
  constexpr int kProducts = 3 * kParts;
  constexpr uint32_t kOrderI = kParts == 3 ? 0x119Au : 0x06u;
  constexpr uint32_t kOrderJ = kParts == 3 ? 0x4926u : 0x00u;
  extern __shared__ unsigned char tc_smem_raw[];
  unsigned char* smem =
      tc_smem_raw + ((1024 - (hopper::smem_addr(tc_smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // stage loaded
  uint64_t* empty = full + kTcMaxStages;                // stage consumed
  uint64_t* strip_bar = empty + kTcMaxStages;           // strip staged
  float* s_y = reinterpret_cast<float*>(smem + plan.off_y);
  float* s_thr = reinterpret_cast<float*>(smem + plan.off_thr);
  float* s_strip = reinterpret_cast<float*>(smem + plan.off_strip);
  unsigned char* ring = smem + plan.off_ring;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < plan.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kWgs);
    }
    for (int g = 0; g < kWgs; ++g) mbar_init(&strip_bar[g], 1);
    hopper::fence_mbar_init();
  }
  for (int i = threadIdx.x; i <= p; i += blockDim.x) s_y[i] = y_table[i];
  if (!thr_stride)
    for (int i = threadIdx.x; i < p; i += blockDim.x) s_thr[i] = thr[i];
  __syncthreads();
  const int k_tiles = (k_dim + kTileK - 1) / kTileK;

  if (warp == 4 * kWgs) {
    // the producer: every stage's w boxes and x tiles by TMA
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < plan.tiles; tile += gridDim.x) {
        const int m0 = (tile % plan.m_tiles) * kRows;
        const int n0 = (tile / plan.m_tiles) * kCols;
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], plan.stage_bytes);
          unsigned char* dst = ring + stage * plan.stage_bytes;
#pragma unroll
          for (int b = 0; b < kCols / kBoxCols; ++b)
            hopper::tma_load_2d(dst + b * kBoxBytes, &w_map, n0 + b * kBoxCols,
                                kt * kTileK, &full[stage]);
#pragma unroll
          for (int q = 0; q < kParts; ++q)
            hopper::tma_load_2d(dst + plan.w_bytes + q * plan.x_bytes,
                                &x_maps.part[q], kt * kTileK, m0,
                                &full[stage]);
          if (++stage == plan.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // the consumers: warp wq of warpgroup g, lane (q, t) = (lane / 4, lane % 4)
  const int g = warp / 4, wq = warp % 4, q = lane / 4, t = lane % 4;
  // its w pairs: columns 64 g + 16 wq + 2 q (+1) of the tile, in box
  // 2 g + wq / 2 at column 16 (wq % 2) + 2 q; K rows 2t, 2t + 1 (+8) of
  // each 16, their 16-byte chunk swizzled with the row (the TMA's 128-byte
  // swizzle on a 1024-aligned box)
  const int chunk = 4 * (wq & 1) + q / 2;
  const uint32_t a_off = (2 * g + wq / 2) * kBoxBytes + 8 * (q & 1);
  const uint32_t r0 = a_off + 2 * t * 128 + ((chunk ^ (2 * t)) << 4);
  const uint32_t r1 = a_off + (2 * t + 1) * 128 + ((chunk ^ (2 * t + 1)) << 4);
  const uint32_t ring_s = hopper::smem_addr(ring);
  const int ng0 = kWgCols * g, nl = 16 * wq + 2 * q;
  float* strip = s_strip + g * plan.strip_floats;
  const int start = (thr_stride && !(p & 1)) ? q % p : 0;

  int stage = 0;
  uint32_t phase = 0, strip_phase = 0;
  float acc[kAcc], part[kAcc];
  for (int tile = blockIdx.x; tile < plan.tiles; tile += gridDim.x) {
    const int m0 = (tile % plan.m_tiles) * kRows;
    const int ng = (tile / plan.m_tiles) * kCols + ng0;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    // every output sums its K in one order, whatever the tile or ring
    // depth: 32 rows at a time in increasing K, each 32's products summed
    // on the tensor cores from zero (16 rows at a time, smallest products
    // first), then added to the float32 sum with one rounding
    for (int kt = 0; kt < k_tiles; ++kt) {
      mbar_wait(&full[stage], phase);
      const unsigned char* st = ring + stage * plan.stage_bytes;
      const uint32_t xs = ring_s + stage * plan.stage_bytes + plan.w_bytes;
      // a 16-row step's w parts are split while the step before it runs
      uint32_t a[2][3][4];
      split_w_step(st, r0, r1, a[0]);
#pragma unroll
      for (int kk = 0; kk < kTileK / 16; ++kk) {
        hopper::wgmma_fence();
#pragma unroll
        for (int u = 0; u < kProducts; ++u) {
          const int i = (kOrderI >> (2 * u)) & 3;
          const int j = (kOrderJ >> (2 * u)) & 3;
          WgmmaRS<kRows>::mma(
              part, a[kk & 1][i],
              hopper::kmajor_sw128_desc(xs + j * plan.x_bytes + 32 * kk),
              u > 0 || kk % kPromoteSteps);
        }
        hopper::wgmma_commit();
        if (kk + 1 < kTileK / 16)
          split_w_step(st + (kk + 1) * 16 * 128, r0, r1, a[(kk + 1) & 1]);
        hopper::wgmma_wait<0>();
        if (kk % kPromoteSteps == kPromoteSteps - 1) {
#pragma unroll
          for (int i = 0; i < kAcc; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == plan.stages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // the epilogue, from the accumulators: bias, the strict count against
    // this thread's two columns' thresholds (a banked strip staged in
    // shared memory by one bulk copy; an even P starts lane group q at
    // threshold q so the 8 groups' rows spread over the banks), the table
    const float* t0 = s_thr;
    const float* t1 = s_thr;
    if (thr_stride) {
      hopper::named_sync(2 + g, 128);  // the strip's last readers are done
      const int n_here = min(kWgCols, n_dim - ng);
      const int nf = n_here > 0 ? n_here * p : 0;
      const float* src = thr + (size_t)(ng < n_dim ? ng : 0) * thr_stride;
      if (nf > 0 && nf % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
        if (threadIdx.x % 128 == 0) {
          mbar_expect_tx(&strip_bar[g], 4u * nf);
          hopper::bulk_load(strip, src, 4u * nf, &strip_bar[g]);
        }
        mbar_wait(&strip_bar[g], strip_phase);
        strip_phase ^= 1;
      } else {
        for (int i = threadIdx.x % 128; i < nf; i += 128) strip[i] = src[i];
        hopper::named_sync(2 + g, 128);
      }
      t0 = strip + nl * p;
      t1 = t0 + p;
    }
    const int n = ng + nl;
    const float b0 = (bias != nullptr && n < n_dim) ? bias[n] : 0.f;
    const float b1 = (bias != nullptr && n + 1 < n_dim) ? bias[n + 1] : 0.f;
#pragma unroll
    for (int j0 = 0; j0 < kRows / 8; j0 += 4) {
      float v[4][2][2];
      int c[4][2][2];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          v[u][0][cc] = acc[4 * (j0 + u) + cc];
          v[u][1][cc] = acc[4 * (j0 + u) + 2 + cc];
          if (bias != nullptr) {
            v[u][0][cc] = __fadd_rn(v[u][0][cc], b0);
            v[u][1][cc] = __fadd_rn(v[u][1][cc], b1);
          }
          c[u][0][cc] = 0;
          c[u][1][cc] = 0;
        }
      int j = start;
      for (int jj = 0; jj < p; ++jj) {
        const float ta = t0[j], tb = t1[j];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            c[u][0][cc] -= hopper::gt_mask(v[u][0][cc], ta);
            c[u][1][cc] -= hopper::gt_mask(v[u][1][cc], tb);
          }
        j = j + 1 == p ? 0 : j + 1;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int m = m0 + 8 * (j0 + u) + 2 * t + cc;
          if (m < m_dim && n < n_dim)
            store_pair(out + (size_t)m * n_dim, n, s_y[c[u][0][cc]],
                       s_y[c[u][1][cc]]);
        }
    }
  }
}

// x (M, K) as kParts bfloat16 parts (kParts, M, k_pad), K padded with
// zeros to k_pad: float32 x split as w is (three parts), bfloat16 x copied
// (one part: a row pitch TMA takes, or an aligned base)
template <typename T>
__global__ void stage_x_kernel(const T* __restrict__ x,
                               uint16_t* __restrict__ parts, int m_dim,
                               int k_dim, int k_pad) {
  const size_t total = (size_t)m_dim * k_pad;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t m = i / k_pad;
    const int k = (int)(i % k_pad);
    const float v = k < k_dim ? to_float(x[m * k_dim + k]) : 0.f;
    if (sizeof(T) == 2) {
      parts[i] = (uint16_t)(__float_as_uint(v) >> 16);  // v is a bfloat16
    } else {
      uint32_t p1, p2, p3;
      hopper::split3_pair(v, 0.f, p1, p2, p3);
      parts[i] = (uint16_t)p1;
      parts[total + i] = (uint16_t)p2;
      parts[2 * total + i] = (uint16_t)p3;
    }
  }
}

template <typename T, int kRows, int kWgs>
int tc_launch(const void* x, void* x_parts, const float* w, const float* bias,
              const float* thr, const float* y_table, void* out, int m_dim,
              int k_dim, int n_dim, int p, int thr_stride, int stages_cap,
              cudaStream_t stream) {
  constexpr int kParts = sizeof(T) == 4 ? 3 : 1;
  if (stages_cap < 2 || stages_cap > kTcMaxStages || n_dim % 4 ||
      reinterpret_cast<uintptr_t>(w) % 16 ||
      (x_parts == nullptr && (kParts != 1 || ((size_t)k_dim * 2) % 16 ||
                              reinterpret_cast<uintptr_t>(x) % 16)))
    return (int)cudaErrorInvalidValue;
  const TcPlan plan = tc_plan(kRows, kWgs, kParts, stages_cap, m_dim, n_dim,
                              p, thr_stride != 0);
  if (plan.stages < 2) return (int)cudaErrorInvalidValue;
  const int kk = k_dim > 0 ? k_dim : 1;
  CUtensorMap w_map;
  {
    const uint64_t dims[2] = {(uint64_t)n_dim, (uint64_t)kk};
    const uint32_t box[2] = {kBoxCols, kTileK};
    if (hopper::tensor_map_2d_sw128(w, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, dims,
                                    (uint64_t)n_dim * 4, box, &w_map) != 0)
      return (int)cudaErrorInvalidValue;
  }
  XMaps xm;
  memset(&xm, 0, sizeof(xm));
  const uint32_t xbox[2] = {kTileK, kRows};
  if (x_parts != nullptr) {
    const int k_pad = (kk + 7) / 8 * 8;
    const size_t total = (size_t)m_dim * k_pad;
    const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256
                                                         : 4096);
    stage_x_kernel<T><<<blocks, 256, 0, stream>>>(
        static_cast<const T*>(x), static_cast<uint16_t*>(x_parts), m_dim,
        k_dim, k_pad);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    for (int q = 0; q < kParts; ++q) {
      const uint64_t dims[2] = {(uint64_t)k_pad, (uint64_t)m_dim};
      if (hopper::tensor_map_2d_sw128(
              static_cast<uint16_t*>(x_parts) + q * total,
              CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, dims, (uint64_t)k_pad * 2,
              xbox, &xm.part[q]) != 0)
        return (int)cudaErrorInvalidValue;
    }
  } else {
    const uint64_t dims[2] = {(uint64_t)kk, (uint64_t)m_dim};
    if (hopper::tensor_map_2d_sw128(x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, dims,
                                    (uint64_t)k_dim * 2, xbox,
                                    &xm.part[0]) != 0)
      return (int)cudaErrorInvalidValue;
  }
  const int set = hopper::func_attribute_at_least<
      fused_gemm_nladc_kernel<T, kRows, kWgs>,
      cudaFuncAttributeMaxDynamicSharedMemorySize>((int)plan.total);
  if (set != 0) return set;
  const int sms = hopper::sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int grid = plan.tiles < sms ? plan.tiles : sms;
  fused_gemm_nladc_kernel<T, kRows, kWgs>
      <<<grid, 128 * kWgs + 32, plan.total, stream>>>(
          w_map, xm, bias, thr, y_table, static_cast<T*>(out), m_dim, k_dim,
          n_dim, p, thr_stride, plan);
  return (int)cudaGetLastError();
}

// The template instance of a GEMM config (rows, cols, stages): x rows a
// tile (64 or 128), output columns a tile (64 or 128: one or two consumer
// warpgroups), the ring depth cap (2 to 4).
template <typename T>
int tc_dispatch(const void* x, void* x_parts, const float* w,
                const float* bias, const float* thr, const float* y_table,
                void* out, int m_dim, int k_dim, int n_dim, int p,
                int thr_stride, int rows, int cols, int stages,
                cudaStream_t stream) {
#define TC_CASE(R, W)                                                       \
  if (rows == R && cols == kWgCols * W)                                     \
    return tc_launch<T, R, W>(x, x_parts, w, bias, thr, y_table, out,       \
                              m_dim, k_dim, n_dim, p, thr_stride, stages,  \
                              stream);
  TC_CASE(64, 1) TC_CASE(64, 2) TC_CASE(128, 1) TC_CASE(128, 2)
#undef TC_CASE
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

// The dense gate for M > 8 (fused_gemm_nladc_kernel) with the GEMM config
// (rows, cols, stages).  x_parts: null to read bfloat16 x in place (K x 2
// bytes a multiple of 16, x 16-byte aligned), else P x M x k_pad bfloat16
// of device memory (P 3 for float32 x, 1 for bfloat16; k_pad = K rounded
// up to 8) that the launch fills first.  Needs N a multiple of 4 and w
// 16-byte aligned.  Returns cudaGetLastError(), or cudaErrorInvalidValue
// for a config or shape the kernel does not take.
int fused_gemm_nladc_launch(const void* x, void* x_parts, const float* w,
                            const float* bias, const float* thr,
                            const float* y_table, void* out, int m_dim,
                            int k_dim, int n_dim, int p, int thr_stride,
                            int x_bf16, int rows, int cols, int stages,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16)
    return tc_dispatch<__nv_bfloat16>(x, x_parts, w, bias, thr, y_table, out,
                                      m_dim, k_dim, n_dim, p, thr_stride,
                                      rows, cols, stages, s);
  if (x_parts == nullptr) return (int)cudaErrorInvalidValue;
  return tc_dispatch<float>(x, x_parts, w, bias, thr, y_table, out, m_dim,
                            k_dim, n_dim, p, thr_stride, rows, cols, stages,
                            s);
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
