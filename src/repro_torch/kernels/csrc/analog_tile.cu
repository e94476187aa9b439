// One analog crossbar tile end to end for sm_90a.
//
// Replaces the TPU kernel
// src/repro/kernels/crossbar_mac.py::analog_tile_pallas:
//
//   xq[m, k]  = round(clip(float(x[m, k]), -x_max, x_max) * r) * step
//               (PWM input quantization; skipped without input bits)
//   we[k, n]  = w[k, n] + noise[k, n]      (pre-sampled read noise; or w)
//   acc[m, n] = sum_k xq[m, k] * we[k, n]                      in float32
//   n         = #{j : acc[m, n] > thr[j]}                  (strict, P of them)
//   out[m, n] = closed-form decode of n                  rounded to x's type
//
// x is (M, K) float32 or bfloat16, w and noise (K, N) float32, thr one (P,)
// ramp (the Pallas kernel takes no banks).  The float32 step and its
// float32 reciprocal r come from the wrapper: under jax.jit XLA compiles the
// reference's division by the step into this multiplication.  rintf rounds
// half to even, as jnp.round.
//
// The decode is the Pallas body's closed form (src/repro/kernels/ref.py::
// closed_form_decode), not a y-table lookup: under jax.jit XLA contracts
// y0 + d * lsb into one fused multiply-add, so it is written __fmaf_rn(d,
// lsb, y0), with d = n (affine ramps), d = m - n left of the split and
// n - m right of it (V-shaped ramps), or d = n - m on both sides (the
// signed split, where y0 - (m - n) * lsb contracts to fma(n - m, lsb, y0)).
//
// Bound on this card: the PTB LSTM's 632 x 8064 gate crossbar as one tile
// at B 16 reads w and the noise (2 x 20.4 MB) once: 12.3 us at 3.35 TB/s
// against 2.4 us of float32 operations at 67 TFLOP/s, so it is bound by
// bytes; the autotune sweep's (128, 256, 256) moves 0.8 MB, 0.24 us, and is
// bound by launch latency.  The design is the fused matmul's
// (csrc/fused_matmul_nladc.cu), which streams the weight once with every
// load coalesced:
//
//   * a block owns `cols` columns (32 or 64: one or two per lane) and kRows
//     rows of x (4, 8 or 16); each of its 16 warps walks its own share of K
//     (k = warp, warp + 16, ...), a lane reading one column of a weight row
//     and, with noise, the same element of the noise, adding the two with
//     one rounding before the product;
//   * x is staged in shared memory as float32, `tile_k` columns of K at a
//     time (a power of two from 16 to 2048), K-major (a k's kRows values
//     side by side), quantized on the way in;
//   * the 16 warps' partial sums meet in shared memory and are added in
//     warp order, so the result does not depend on scheduling, nor on the
//     launch config (kernels/tune.py): every (rows, cols, tile_k) computes
//     the same bits;
//   * the epilogue (P compares, the closed-form decode, round to nearest
//     even) runs on the float32 sum, one thread per output.
//
// The summation order is not XLA's, so an accumulator within float32
// rounding of a threshold may land on the other side of it: the contract
// is the fused matmul's code_flips on the effective operands pwm(x) and
// w + noise.  Products and sums are __fmaf_rn / __fadd_rn / __fmul_rn so
// nvcc's --fmad choice cannot change the rounding.  Rows of x past M are
// staged as zeros and their outputs are not written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 16;  // the K split: fixed, it sets the summation order
constexpr int kThreads = 32 * kWarps;

constexpr int kAffine = 0;  // y(n) = y0 + n * lsb
constexpr int kVShape = 1;  // y(n) = y0 + |n - m| * lsb_{l,r}
constexpr int kSigned = 2;  // y(n) = y0 + (n - m) * lsb_{l,r}

struct Pwm {
  int on;
  float x_max, recip, step;
};

struct Decode {
  int mode, m;
  float y0, lsb_l, lsb_r;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float pwm(float v, const Pwm& q) {
  if (!q.on) return v;
  v = fminf(fmaxf(v, -q.x_max), q.x_max);
  return __fmul_rn(rintf(__fmul_rn(v, q.recip)), q.step);
}

__device__ __forceinline__ float decode(int n, const Decode& d) {
  if (d.mode == kAffine) return __fmaf_rn((float)n, d.lsb_l, d.y0);
  if (n <= d.m)
    return __fmaf_rn((float)(d.mode == kVShape ? d.m - n : n - d.m),
                     d.lsb_l, d.y0);
  return __fmaf_rn((float)(n - d.m), d.lsb_r, d.y0);
}

// One block: columns n0 .. n0+kCols-1 and rows m0 .. m0+kRows-1.
template <typename T, int kRows, int kColsPerLane, bool kNoise>
__global__ void __launch_bounds__(kThreads) analog_tile_kernel(
    const T* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ nz, const float* __restrict__ thr,
    T* __restrict__ out, int m_dim, int k_dim, int n_dim, int p, int tile_k,
    Pwm q, Decode d) {
  constexpr int kCols = 32 * kColsPerLane;
  extern __shared__ float smem[];
  float* s_x = smem;                                  // tile_k x kRows
  float* s_part = s_x + kRows * tile_k;               // kWarps x kRows x kCols
  float* s_thr = s_part + kWarps * kRows * kCols;     // P

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
              ? pwm(to_float(x[(size_t)(m0 + r) * k_dim + k0 + kk]), q)
              : 0.f;
    }
    __syncthreads();
#pragma unroll 16
    for (int kk = warp; kk < kt; kk += kWarps) {
      const size_t row = (size_t)(k0 + kk) * n_dim;
      float wv[kColsPerLane];
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) {
        const int n = n0 + lane + 32 * c;
        float v = 0.f;
        if (n < n_dim) {
          v = __ldg(w + row + n);
          if (kNoise) v = __fadd_rn(v, __ldg(nz + row + n));
        }
        wv[c] = v;
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
  for (int i = threadIdx.x; i < p; i += kThreads) s_thr[i] = thr[i];
  __syncthreads();

  for (int i = threadIdx.x; i < kRows * kCols; i += kThreads) {
    const int r = i / kCols, col = i % kCols;
    const int n = n0 + col;
    if (r >= rows || n >= n_dim) continue;
    float s = s_part[r * kCols + col];
#pragma unroll
    for (int wi = 1; wi < kWarps; ++wi)
      s = __fadd_rn(s, s_part[(wi * kRows + r) * kCols + col]);
    int count = 0;
    for (int j = 0; j < p; ++j) count += (s > s_thr[j]) ? 1 : 0;
    store(out + (size_t)(m0 + r) * n_dim + n, decode(count, d));
  }
}

template <typename T, int kRows, int kColsPerLane, bool kNoise>
int launch(const void* x, const float* w, const float* nz, const float* thr,
           void* out, int m_dim, int k_dim, int n_dim, int p, int tile_k,
           const Pwm& q, const Decode& d, cudaStream_t stream) {
  constexpr int kCols = 32 * kColsPerLane;
  const size_t smem =
      sizeof(float) * ((size_t)kRows * tile_k +
                       (size_t)kWarps * kRows * kCols + p);
  auto kernel = analog_tile_kernel<T, kRows, kColsPerLane, kNoise>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((n_dim + kCols - 1) / kCols, (m_dim + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), w, nz, thr, static_cast<T*>(out), m_dim,
      k_dim, n_dim, p, tile_k, q, d);
  return (int)cudaGetLastError();
}

template <typename T, bool kNoise>
int dispatch(const void* x, const float* w, const float* nz,
             const float* thr, void* out, int m_dim, int k_dim, int n_dim,
             int p, int rows, int cols, int tile_k, const Pwm& q,
             const Decode& d, cudaStream_t stream) {
#define AT_CASE(R, C)                                                      \
  if (rows == R && cols == 32 * C)                                         \
    return launch<T, R, C, kNoise>(x, w, nz, thr, out, m_dim, k_dim, n_dim, \
                                   p, tile_k, q, d, stream);
  AT_CASE(4, 1) AT_CASE(8, 1) AT_CASE(16, 1)
  AT_CASE(4, 2) AT_CASE(8, 2) AT_CASE(16, 2)
#undef AT_CASE
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_noise(const void* x, const float* w, const float* nz,
                   const float* thr, void* out, int m_dim, int k_dim,
                   int n_dim, int p, int rows, int cols, int tile_k,
                   const Pwm& q, const Decode& d, cudaStream_t stream) {
  if (nz != nullptr)
    return dispatch<T, true>(x, w, nz, thr, out, m_dim, k_dim, n_dim, p, rows,
                             cols, tile_k, q, d, stream);
  return dispatch<T, false>(x, w, nz, thr, out, m_dim, k_dim, n_dim, p, rows,
                            cols, tile_k, q, d, stream);
}

}  // namespace

extern "C" {

// x and out are bfloat16 when x_bf16 is nonzero, else float32; nz may be
// null (no read noise).  pwm_on selects the PWM quantization with
// (x_max, recip, step); (mode, m, y0, lsb_l, lsb_r) is the closed-form
// decode; (rows, cols, tile_k) the launch config.  Launches on `stream`;
// allocates nothing.  Returns cudaGetLastError(), or cudaErrorInvalidValue
// for a config without a template instance.
int analog_tile_launch(const void* x, const float* w, const float* nz,
                       const float* thr, void* out, int m_dim, int k_dim,
                       int n_dim, int p, int x_bf16, int pwm_on, float x_max,
                       float recip, float step, int mode, int m, float y0,
                       float lsb_l, float lsb_r, int rows, int cols,
                       int tile_k, void* stream) {
  if (tile_k < 16 || tile_k > 2048 || (tile_k & (tile_k - 1)) ||
      mode < kAffine || mode > kSigned)
    return (int)cudaErrorInvalidValue;
  const Pwm q{pwm_on, x_max, recip, step};
  const Decode d{mode, m, y0, lsb_l, lsb_r};
  cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16)
    return dispatch_noise<__nv_bfloat16>(x, w, nz, thr, out, m_dim, k_dim,
                                         n_dim, p, rows, cols, tile_k, q, d,
                                         s);
  return dispatch_noise<float>(x, w, nz, thr, out, m_dim, k_dim, n_dim, p,
                               rows, cols, tile_k, q, d, s);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
