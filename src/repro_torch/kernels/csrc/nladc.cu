// Elementwise NL-ADC for sm_90a.
//
// Replaces the TPU kernel
// src/repro/kernels/nladc_kernel.py::nladc_pallas:
//
//   out[..., n] = y_table[#{j : float(x[..., n]) > thr[j]}]   in x's type
//
// x is any tensor of float32 or bfloat16 seen as (M, N) rows of its last
// axis; thr is one (P,) ramp for every column or one row of an (N, P)
// per-column matrix (the threshold-bank layout).  The comparator is strict,
// every compare runs over all P thresholds (no early exit: the count is
// #{thr_j < x} whatever the order of thr), and NaN counts 0.  The decode is
// a lookup in the ramp's y table, as the port's reference backend decodes
// (the Pallas kernel decodes in closed form; the codes are the same), and
// the value is rounded to bfloat16 to nearest even (__float2bfloat16_rn), as
// PyTorch's cast.
//
// Bound on this card: on the serving path the kernel quantizes the MoE
// router's sigmoid scores, (4, 64) bfloat16 at a decode step and (1, 64) at
// a prefill position: 1.3 KB in and out with the ramp, 32 compares an
// element.  No design takes that much below an empty launch, so the call is
// the launch plus one device round trip and a short chain of compares.  At
// the MLP width with 512-column banks, (4, 11008) bfloat16, the (N, P)
// matrix is 1.41 MB of the 1.59 MB a call must move (0.47 us at
// 3.35 TB/s), and every byte of it is read once.  One kernel for both
// threshold layouts:
//
//   * a CTA has one warp per row it can take (the launch config's rows,
//     fewer where x has fewer rows, so M = 1 or 4 leaves no warp idle) and
//     covers a strip of `cols` columns, each lane every 32nd one; warps walk
//     rows with a stride of gridDim.y x warps, so any M takes one launch and
//     a CTA's thresholds serve every row it takes;
//   * a lane issues its x loads first, then loads a (P,) ramp (one
//     broadcast line) into registers and its entry of the y table, decodes
//     by a warp shuffle of the table (y[P] beside it) and stores: no shared
//     memory and no barrier;
//   * an (N, P) matrix: the strip's rows (one contiguous run of cols x P
//     floats) come into shared memory by one bulk copy on an mbarrier,
//     issued by thread 0 before any other load (plain loads where the run
//     is not 16-byte aligned); after the block's one barrier each lane
//     copies its column's row into registers, starting at its own
//     threshold so that 32 rows of 32 floats do not share a bank.
//
// P is a template constant for the 3-, 4- and 5-bit ADCs (P = 8, 16, 32), so
// the P compares unroll, each one set.gt summed as a tree; any other P takes
// one run-time instance that reads thresholds and table from device memory.
//
// Launch config (kernels/tune.py): (rows, cols) = rows in flight per CTA
// (one a warp: 4, 8 or 16) and columns per CTA (32, 64, 128 or 256), as
// template instances of the columns; the launch clips the rows to M.  Each
// element's result does not depend on either.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kMaxGridY = 2048;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// blockDim.x / 32 warps, each a row at a time (rows blockIdx.y * warps +
// warp, then every gridDim.y * warps-th); lane l takes columns n0 + l + 32 c,
// c < kColsPerLane, of the CTA's strip from n0 = blockIdx.x * 32 *
// kColsPerLane.  kBanked: thr is (N, P), and the strip's rows of it are
// staged in shared memory once for all the rows the CTA takes.
template <typename T, int kColsPerLane, int kP, bool kBanked>
__global__ void __launch_bounds__(512)
    nladc_kernel(const T* __restrict__ x, const float* __restrict__ thr,
                 const float* __restrict__ y_table, T* __restrict__ out,
                 int m_rows, int n_cols, int p) {
  constexpr int kCols = 32 * kColsPerLane;
  const int lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  const int n0 = blockIdx.x * kCols;
  const int row_stride = gridDim.y * warps;
  int r = blockIdx.y * warps + threadIdx.x / 32;

  // the strip's rows of an (N, P) matrix are one contiguous run of
  // kCols x P floats: a bulk copy into shared memory, issued first
  constexpr bool kStaged = kBanked && kP > 0;
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t bar;
  hopper::Strips<1> st;
  if constexpr (kStaged) {
    st.add(smem, thr + (size_t)n0 * kP, min(kCols, n_cols - n0) * kP);
    st.issue(&bar);
  }
  if (!kStaged && r >= m_rows) return;  // the whole warp

  float v[kColsPerLane];
  auto load = [&](int row) {
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) {
      const int n = n0 + lane + 32 * c;
      v[c] = n < n_cols ? to_float(x[(size_t)row * n_cols + n]) : 0.f;
    }
  };
  if (r < m_rows) load(r);
  // a (P,) ramp: one broadcast line into registers; the y table: one entry
  // a lane, for the shuffle decode
  float t[kP ? kP : 1];
  float y_lane = 0.f, y_last = 0.f;
  if constexpr (kP > 0) {
    if constexpr (!kBanked) {
#pragma unroll
      for (int k = 0; k < kP; ++k) t[k] = __ldg(thr + k);
    }
    y_lane = __ldg(y_table + (lane < kP ? lane : kP));
    y_last = __ldg(y_table + kP);
  }
  if constexpr (kStaged) {
    st.land(&bar);
    if (r >= m_rows) return;  // the whole warp, after the block's barrier
  }

  while (true) {
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) {
      const int n = n0 + lane + 32 * c;
      float y;
      if constexpr (kP > 0) {
        if constexpr (kBanked)
          hopper::load_rotated<kP>(t, smem + (lane + 32 * c) * kP, lane);
        y = hopper::table_at<kP>(y_lane, y_last, hopper::count_gt<kP>(v[c], t));
      } else {
        const float* tc = kBanked ? thr + (size_t)(n < n_cols ? n : 0) * p
                                  : thr;
        int count = 0;
        for (int k = 0; k < p; ++k) count += (v[c] > __ldg(tc + k)) ? 1 : 0;
        y = __ldg(y_table + count);
      }
      if (n < n_cols) out[(size_t)r * n_cols + n] = from_float<T>(y);
    }
    r += row_stride;
    if (r >= m_rows) break;
    load(r);
  }
}

template <typename T, int kColsPerLane, int kP, bool kBanked>
int launch(const void* x, const float* thr, const float* y_table, void* out,
           int m_rows, int n_cols, int p, int rows, cudaStream_t stream) {
  constexpr int kCols = 32 * kColsPerLane;
  rows = rows < m_rows ? rows : m_rows;  // no warp without a row
  const int row_blocks = (m_rows + rows - 1) / rows;
  const dim3 grid((n_cols + kCols - 1) / kCols,
                  row_blocks < kMaxGridY ? row_blocks : kMaxGridY);
  // the template instances stage the strip of an (N, P) matrix
  const size_t smem = (kBanked && kP > 0) ? sizeof(float) * kCols * kP : 0;
  nladc_kernel<T, kColsPerLane, kP, kBanked>
      <<<grid, 32 * rows, smem, stream>>>(static_cast<const T*>(x), thr,
                                          y_table, static_cast<T*>(out),
                                          m_rows, n_cols, p);
  return (int)cudaGetLastError();
}

// The template instance of one call; a config without one returns
// cudaErrorInvalidValue.  P = 8, 16, 32 (the 3-, 4- and 5-bit ADCs) are
// template constants, any other P the run-time instance.
template <typename T, int kP>
int dispatch_cols(const void* x, const float* thr, const float* y_table,
                  void* out, int m_rows, int n_cols, int p, bool banked,
                  int rows, int cols, cudaStream_t stream) {
#define NLADC_CASE(C)                                                       \
  if (cols == 32 * C)                                                       \
    return banked ? launch<T, C, kP, true>(x, thr, y_table, out, m_rows,    \
                                           n_cols, p, rows, stream)         \
                  : launch<T, C, kP, false>(x, thr, y_table, out, m_rows,   \
                                            n_cols, p, rows, stream);
  NLADC_CASE(1) NLADC_CASE(2) NLADC_CASE(4) NLADC_CASE(8)
#undef NLADC_CASE
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch(const void* x, const float* thr, const float* y_table, void* out,
             int m_rows, int n_cols, int p, bool banked, int rows, int cols,
             cudaStream_t stream) {
  if (rows < 1 || rows > 16) return (int)cudaErrorInvalidValue;
  if (p == 8)
    return dispatch_cols<T, 8>(x, thr, y_table, out, m_rows, n_cols, p,
                               banked, rows, cols, stream);
  if (p == 16)
    return dispatch_cols<T, 16>(x, thr, y_table, out, m_rows, n_cols, p,
                                banked, rows, cols, stream);
  if (p == 32)
    return dispatch_cols<T, 32>(x, thr, y_table, out, m_rows, n_cols, p,
                                banked, rows, cols, stream);
  return dispatch_cols<T, 0>(x, thr, y_table, out, m_rows, n_cols, p, banked,
                             rows, cols, stream);
}

}  // namespace

extern "C" {

// x and out are bfloat16 when x_bf16 is nonzero, else float32; both hold
// m_rows x n_cols elements, row-major.  thr_stride: P for an (N, P) matrix,
// 0 for a (P,) ramp.  (rows, cols): warps (rows in flight, at most m_rows
// of them launched) and columns of a CTA.  Launches on `stream`; allocates
// nothing; m_rows and n_cols are positive.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a config without a template instance.
int nladc_launch(const void* x, const float* thr, const float* y_table,
                 void* out, int m_rows, int n_cols, int p, int thr_stride,
                 int x_bf16, int rows, int cols, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16)
    return dispatch<__nv_bfloat16>(x, thr, y_table, out, m_rows, n_cols, p,
                                   thr_stride != 0, rows, cols, s);
  return dispatch<float>(x, thr, y_table, out, m_rows, n_cols, p,
                         thr_stride != 0, rows, cols, s);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
