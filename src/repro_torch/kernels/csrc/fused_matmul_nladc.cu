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
//    one threshold set shared by every expert.  Here it is one grouped
//    launch with the expert on the grid's z axis: the block's x, w and out
//    pointers step by one expert's (C, K), (K, N) and (C, N) slabs.
//
// x is (M, K) or (E, C, K) float32 or bfloat16, w the (K, N) or (E, K, N)
// float32 master weights, thr one (P,) ramp for every column (stride 0) or
// one row of an (N, P) per-column matrix (stride P, the threshold-bank
// layout).  The comparator is strict, and the decode is a lookup in the
// ramp's y table, as the port's reference backend decodes.
//
// Bound on this card: the LM's MLP gate (qwen2.5-3b, K 2048, N 11008) runs
// with M = 4 (a decode step) or M = 1 (a prefill step).  Each call then
// reads the 90.2 MB float32 weight once and does 2*M*K*N = 180 MFLOP, so
// it is bound by bytes: 27 us at 3.35 TB/s, against 2.7 us of float32
// operations at 67 TFLOP/s.  The routed-expert gate (moonshot-v1-16b-a3b,
// E 64, C 6, K 2048, N 1408) reads all 64 experts' 738 MB of weight (the
// reference's einsum runs over every expert, empty capacity rows
// included): 220 us of bytes against 33 us of operations.  Tensor cores
// would not help a GEMV.  The design streams w through the card once, with
// every load coalesced:
//
//   * a block owns 32 columns and kRows rows of x (by default 4 for the
//     dense gate, 8 for the expert gate, so an expert's C = 6 rows take one
//     block and its weight strip is read once); each of its 16 warps walks
//     its own share of K (rows k = warp, warp + 16, ...), each lane reading
//     one column of a weight row (one 128-byte warp load per row, 16 rows
//     unrolled so their loads are in flight together), so one block reads
//     a 32-column strip of w and the grid covers N with 344 blocks at
//     N = 11008, or 44 x 64 = 2816 blocks for the experts (splitting K
//     over 16 warps keeps enough loads in flight per SM);
//   * x is staged in shared memory as float32, 512 columns of K at a
//     time by default, K-major (a k's kRows values side by side, so their
//     offsets are constants whatever the K tile), and read by broadcast;
//   * each thread keeps its kRows accumulators in registers; the 16 warps'
//     partial sums meet in shared memory and are added in warp order, so
//     the result does not depend on scheduling;
//   * the epilogue (bias, P compares, table lookup, round to nearest even)
//     runs on the float32 sum, one thread per output; a per-column
//     threshold strip is staged in shared memory with a padded stride so
//     the threads' row reads do not collide in one bank.
//
// Products and sums are written as __fmaf_rn / __fadd_rn so nvcc's --fmad
// choice cannot change the rounding.  Rows of x past M (the ragged edge)
// are staged as zeros and their outputs are not written.
//
// Launch configs (kernels/tune.py): each launch takes (rows, cols, tile_k)
// at run time: rows of x per block (1, 2, 4 or 8; template instances),
// columns per block (32 or 64: one or two per lane) and the K tile staged
// at a time (a power of two from 16 to 2048).  Warp w always sums k = w,
// w + 16, ... in order and the 16 partial sums meet in warp order, so
// every config computes the same bits; the defaults above are the ones
// the wrapper takes when no tune cache or override names another.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 16;  // the K split: fixed, it sets the summation order
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One block: columns n0 .. n0+kCols-1 and rows m0 .. m0+kRows-1 of the
// (M, K) @ (K, N) product of expert blockIdx.z (0 for the dense gate).
template <typename T, int kRows, int kColsPerLane>
__global__ void __launch_bounds__(kThreads) fused_matmul_nladc_kernel(
    const T* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ thr,
    const float* __restrict__ y_table, T* __restrict__ out, int m_dim,
    int k_dim, int n_dim, int p, int thr_stride, int tile_k) {
  constexpr int kCols = 32 * kColsPerLane;
  x += (size_t)blockIdx.z * m_dim * k_dim;
  w += (size_t)blockIdx.z * k_dim * n_dim;
  out += (size_t)blockIdx.z * m_dim * n_dim;
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
#pragma unroll 16
    for (int kk = warp; kk < kt; kk += kWarps) {
      const float* wrow = w + (size_t)(k0 + kk) * n_dim;
      float wv[kColsPerLane];
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) {
        const int n = n0 + lane + 32 * c;
        wv[c] = n < n_dim ? __ldg(wrow + n) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float xv = s_x[kk * kRows + r];
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c)
          acc[r][c] = __fmaf_rn(xv, wv[c], acc[r][c]);
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
           const float* thr, const float* y_table, void* out, int n_experts,
           int m_dim, int k_dim, int n_dim, int p, int thr_stride, int tile_k,
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
  const dim3 grid((n_dim + kCols - 1) / kCols, (m_dim + kRows - 1) / kRows,
                  n_experts);
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
             const float* thr, const float* y_table, void* out,
             int n_experts, int m_dim, int k_dim, int n_dim, int p,
             int thr_stride, int rows, int cols, int tile_k,
             cudaStream_t stream) {
  if (tile_k < 16 || tile_k > 2048 || (tile_k & (tile_k - 1)))
    return (int)cudaErrorInvalidValue;
#define FMN_CASE(R, C)                                                      \
  if (rows == R && cols == 32 * C)                                          \
    return launch<T, R, C>(x, w, bias, thr, y_table, out, n_experts, m_dim, \
                           k_dim, n_dim, p, thr_stride, tile_k, stream);
  FMN_CASE(1, 1) FMN_CASE(2, 1) FMN_CASE(4, 1) FMN_CASE(8, 1)
  FMN_CASE(1, 2) FMN_CASE(2, 2) FMN_CASE(4, 2) FMN_CASE(8, 2)
#undef FMN_CASE
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
    return dispatch<__nv_bfloat16>(x, w, bias, thr, y_table, out, 1, m_dim,
                                   k_dim, n_dim, p, thr_stride, rows, cols,
                                   tile_k, s);
  return dispatch<float>(x, w, bias, thr, y_table, out, 1, m_dim, k_dim,
                         n_dim, p, thr_stride, rows, cols, tile_k, s);
}

// The expert gate: x (E, C, K), w (E, K, N), out (E, C, N), one threshold
// set for every expert, no bias.  Otherwise as above.
int moe_fused_matmul_launch(const void* x, const float* w, const float* thr,
                            const float* y_table, void* out, int n_experts,
                            int c_dim, int k_dim, int n_dim, int p,
                            int thr_stride, int x_bf16, int rows, int cols,
                            int tile_k, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16)
    return dispatch<__nv_bfloat16>(x, w, nullptr, thr, y_table, out,
                                   n_experts, c_dim, k_dim, n_dim, p,
                                   thr_stride, rows, cols, tile_k, s);
  return dispatch<float>(x, w, nullptr, thr, y_table, out, n_experts, c_dim,
                         k_dim, n_dim, p, thr_stride, rows, cols, tile_k, s);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
