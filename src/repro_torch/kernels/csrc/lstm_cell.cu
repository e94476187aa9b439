// Fused LSTM elementwise tail (paper Eq. 5 / Fig. S6) for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/lstm_cell.py::lstm_gates_pallas.
// Per element (b, j), j < H, of packed gates (B, 4H) in the order [f|a|i|o]:
//
//   f, i, o = sigmoid NL-ADC of gates[b, j], gates[b, 2H+j], gates[b, 3H+j]
//   a       = tanh NL-ADC of gates[b, H+j]
//   c'      = fma(f, c, i*a)            (one rounding, the port's contract)
//   h'      = o * tanhNLADC(c')
//
// An NL-ADC is the strict comparator count n = #{k : x > thr[k]} followed by
// a lookup y_table[n] (P thresholds, P+1 table entries).  Thresholds are
// either one (P,) ramp shared by every column (stride 0) or one row of an
// (H, P) per-column matrix (stride P, the threshold-bank layout).
//
// Bound on this card: at the main path's shape (B=16, H=2016) one call
// reads gates 16x8064 and c 16x2016 and writes h' and c', about 0.9 MB,
// which is 0.27 us at 3.35 TB/s; the 5 x 32 compares per element are
// 5.2 M operations, 0.08 us at 67 TFLOP/s.  Either is far below the few
// microseconds a launch costs, so the kernel is bound by launch latency.
// The design therefore stays simple: one thread per (b, j), a 2D grid over
// (ceil(H/256), B), the (P,) ramps and both y tables staged in shared
// memory, and the ragged H edge masked in the kernel.  The products are
// written as __fmul_rn / __fmaf_rn so nvcc's --fmad choice cannot change
// the rounding.
//
// Launch config (kernels/tune.py): (rows, threads) at run time, a block of
// `threads` hidden units (a multiple of 32, at most 512) over `rows` batch
// rows (1, 2 or 4: template instances, so the default's single row is
// straight-line code), each thread walking its rows; the default (1, 256)
// is the grid above.  Each element's result does not depend on the
// config.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;

__device__ __forceinline__ int count_below(float x, const float* thr, int p) {
  int n = 0;
  for (int k = 0; k < p; ++k) n += (x > thr[k]) ? 1 : 0;
  return n;
}

template <int kRows>
__global__ void __launch_bounds__(kMaxThreads) lstm_gates_kernel(
    const float* __restrict__ gates, const float* __restrict__ c,
    const float* __restrict__ sig_thr, const float* __restrict__ sig_y,
    const float* __restrict__ tanh_thr, const float* __restrict__ tanh_y,
    float* __restrict__ h_out, float* __restrict__ c_out, int b_dim,
    int h_dim, int p, int sig_stride, int tanh_stride) {
  extern __shared__ float smem[];
  float* s_sig_y = smem;
  float* s_tanh_y = s_sig_y + (p + 1);
  float* s_sig_thr = s_tanh_y + (p + 1);
  float* s_tanh_thr = s_sig_thr + (sig_stride ? 0 : p);
  for (int k = threadIdx.x; k <= p; k += blockDim.x) {
    s_sig_y[k] = sig_y[k];
    s_tanh_y[k] = tanh_y[k];
  }
  if (!sig_stride)
    for (int k = threadIdx.x; k < p; k += blockDim.x) s_sig_thr[k] = sig_thr[k];
  if (!tanh_stride)
    for (int k = threadIdx.x; k < p; k += blockDim.x) s_tanh_thr[k] = tanh_thr[k];
  __syncthreads();

  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= h_dim) return;
  const float* st = sig_stride ? sig_thr + (size_t)j * sig_stride : s_sig_thr;
  const float* tt = tanh_stride ? tanh_thr + (size_t)j * tanh_stride : s_tanh_thr;

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const size_t b = (size_t)blockIdx.y * kRows + r;
    if (kRows > 1 && b >= (size_t)b_dim) break;
    const float* g = gates + b * 4 * (size_t)h_dim + j;
    const float f = s_sig_y[count_below(g[0], st, p)];
    const float a = s_tanh_y[count_below(g[h_dim], tt, p)];
    const float i = s_sig_y[count_below(g[2 * h_dim], st, p)];
    const float o = s_sig_y[count_below(g[3 * h_dim], st, p)];

    const size_t e = b * (size_t)h_dim + j;
    const float c_new = __fmaf_rn(f, c[e], __fmul_rn(i, a));
    const float t = s_tanh_y[count_below(c_new, tt, p)];
    h_out[e] = __fmul_rn(o, t);
    c_out[e] = c_new;
  }
}

}  // namespace

extern "C" {

// (rows, threads) is the launch config.  Launches on `stream`; allocates
// nothing.  Returns cudaGetLastError(), or cudaErrorInvalidValue for a
// config out of range.
int lstm_gates_launch(const float* gates, const float* c,
                      const float* sig_thr, const float* sig_y,
                      const float* tanh_thr, const float* tanh_y,
                      float* h_out, float* c_out, int b_dim, int h_dim, int p,
                      int sig_stride, int tanh_stride, int rows, int threads,
                      void* stream) {
  if (threads < 32 || threads > kMaxThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (2 * (size_t)(p + 1) + (sig_stride ? 0 : p) +
                       (tanh_stride ? 0 : p));
  void (*kernel)(const float*, const float*, const float*, const float*,
                 const float*, const float*, float*, float*, int, int, int,
                 int, int);
  if (rows == 1)
    kernel = lstm_gates_kernel<1>;
  else if (rows == 2)
    kernel = lstm_gates_kernel<2>;
  else if (rows == 4)
    kernel = lstm_gates_kernel<4>;
  else
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((h_dim + threads - 1) / threads, (b_dim + rows - 1) / rows);
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      gates, c, sig_thr, sig_y, tanh_thr, tanh_y, h_out, c_out, b_dim, h_dim,
      p, sig_stride, tanh_stride);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
