// Elementwise NL-ADC for sm_90a.
//
// Replaces the TPU kernel
// src/repro/kernels/nladc_kernel.py::nladc_pallas:
//
//   out[..., n] = y_table[#{j : float(x[..., n]) > thr[j]}]   in x's type
//
// x is any tensor of float32 or bfloat16 seen as (M, N) rows of its last
// axis; thr is one (P,) ramp for every column (stride 0) or one row of an
// (N, P) per-column matrix (stride P, the threshold-bank layout).  The
// comparator is strict, and the decode is a lookup in the ramp's y table,
// as the port's reference backend decodes (the Pallas kernel decodes in
// closed form; the codes are the same).
//
// Bound on this card: on the serving path the kernel quantizes the MoE
// router's sigmoid scores, (4, 64) bfloat16 at a decode step and (1, 64)
// at a prefill position: 512 bytes in and out, 32 compares an element.
// Any launch costs more than that, so what bounds a call is launch
// latency, and the design keeps one launch and few instructions per
// element; at larger widths (the (4, 11008) MLP width) it is bound by the
// bytes of x and the output, and every load is coalesced:
//
//   * a block owns a strip of 32 columns; its 8 warps each take one row at
//     a time, a lane one column, so a warp reads 32 consecutive elements
//     (both by default: the launch takes the warps per block, 4, 8 or 16,
//     and the columns per block, 32, 64, 128 or 256 with each lane taking
//     every 32nd column, at run time, as template instances; see
//     kernels/tune.py; each element's result does not depend on either);
//   * the strip's thresholds (P of them, or 32 rows of P in the per-column
//     layout) and the y table are staged in shared memory once per block,
//     the per-column rows with a padded pitch (P + 1) so the 32 lanes,
//     which read 32 different rows at one j, hit 32 different banks;
//   * the grid covers the columns in x and the rows in y, each block
//     walking rows with a stride of gridDim.y * warps, so a (33, 1000) or a
//     (4, 64) tensor both take one launch.
//
// Every compare runs over all P thresholds (no early exit), so the count
// is #{thr_j < x} whatever the order of thr.  The rounding of the table
// value to bfloat16 is round to nearest even (__float2bfloat16_rn), as
// PyTorch's cast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxGridY = 2048;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// A block of kWarps warps over 32 * kColsPerLane columns.
template <typename T, int kWarps, int kColsPerLane>
__global__ void __launch_bounds__(32 * kWarps) nladc_kernel(
    const T* __restrict__ x, const float* __restrict__ thr,
    const float* __restrict__ y_table, T* __restrict__ out, int m_rows,
    int n_cols, int p, int thr_stride) {
  constexpr int kThreads = 32 * kWarps;
  constexpr int cols = 32 * kColsPerLane;
  extern __shared__ float smem[];
  const int thr_pitch = thr_stride ? p + 1 : p;
  float* s_thr = smem;  // cols x (P+1), or P
  float* s_y = s_thr + (thr_stride ? cols : 1) * thr_pitch;  // P + 1

  const int n0 = blockIdx.x * cols;
  const int n_here = min(cols, n_cols - n0);
  if (thr_stride) {
    // the block's columns n0 .. n0+cols-1 are one contiguous strip of (N, P)
    for (int i = threadIdx.x; i < n_here * p; i += kThreads)
      s_thr[(i / p) * thr_pitch + i % p] = thr[(size_t)n0 * p + i];
  } else {
    for (int i = threadIdx.x; i < p; i += kThreads) s_thr[i] = thr[i];
  }
  for (int i = threadIdx.x; i <= p; i += kThreads) s_y[i] = y_table[i];
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int c = 0; c < kColsPerLane; ++c) {
    const int col = lane + 32 * c;
    if (col >= n_here) break;
    const float* t = thr_stride ? s_thr + col * thr_pitch : s_thr;
    const int n = n0 + col;
    for (int r = blockIdx.y * kWarps + warp; r < m_rows;
         r += gridDim.y * kWarps) {
      const size_t i = (size_t)r * n_cols + n;
      const float v = to_float(x[i]);
      int count = 0;
      for (int j = 0; j < p; ++j) count += (v > t[j]) ? 1 : 0;
      store(out + i, s_y[count]);
    }
  }
}

template <typename T, int kWarps, int kColsPerLane>
int launch(const void* x, const float* thr, const float* y_table, void* out,
           int m_rows, int n_cols, int p, int thr_stride,
           cudaStream_t stream) {
  constexpr int cols = 32 * kColsPerLane;
  const int thr_pitch = thr_stride ? p + 1 : p;
  const size_t smem =
      sizeof(float) * ((size_t)(thr_stride ? cols : 1) * thr_pitch + p + 1);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        nladc_kernel<T, kWarps, kColsPerLane>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int row_blocks = (m_rows + kWarps - 1) / kWarps;
  const dim3 grid((n_cols + cols - 1) / cols,
                  row_blocks < kMaxGridY ? row_blocks : kMaxGridY);
  nladc_kernel<T, kWarps, kColsPerLane><<<grid, 32 * kWarps, smem, stream>>>(
      static_cast<const T*>(x), thr, y_table, static_cast<T*>(out), m_rows,
      n_cols, p, thr_stride);
  return (int)cudaGetLastError();
}

// The template instance of a (warps, cols) config; an unsupported one
// returns cudaErrorInvalidValue.
template <typename T>
int dispatch(const void* x, const float* thr, const float* y_table,
             void* out, int m_rows, int n_cols, int p, int thr_stride,
             int warps, int cols, cudaStream_t stream) {
#define NLADC_CASE(W, C)                                                   \
  if (warps == W && cols == 32 * C)                                        \
    return launch<T, W, C>(x, thr, y_table, out, m_rows, n_cols, p,        \
                           thr_stride, stream);
  NLADC_CASE(4, 1) NLADC_CASE(4, 2) NLADC_CASE(4, 4) NLADC_CASE(4, 8)
  NLADC_CASE(8, 1) NLADC_CASE(8, 2) NLADC_CASE(8, 4) NLADC_CASE(8, 8)
  NLADC_CASE(16, 1) NLADC_CASE(16, 2) NLADC_CASE(16, 4) NLADC_CASE(16, 8)
#undef NLADC_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x and out are bfloat16 when x_bf16 is nonzero, else float32; both hold
// m_rows x n_cols elements, row-major.  (warps, cols) is the launch config.
// Launches on `stream`; allocates nothing.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a config without a template instance.
int nladc_launch(const void* x, const float* thr, const float* y_table,
                 void* out, int m_rows, int n_cols, int p, int thr_stride,
                 int x_bf16, int warps, int cols, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16)
    return dispatch<__nv_bfloat16>(x, thr, y_table, out, m_rows, n_cols, p,
                                   thr_stride, warps, cols, s);
  return dispatch<float>(x, thr, y_table, out, m_rows, n_cols, p, thr_stride,
                         warps, cols, s);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
