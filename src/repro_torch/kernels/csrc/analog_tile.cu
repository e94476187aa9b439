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
// bound by launch latency.  The design is the expert gate's (moe_gate_kernel
// in csrc/fused_matmul_nladc.cu), which streams its weight through a ring of
// TMA loads, without the empty-expert logic:
//
//   * persistent CTAs, one per SM (fewer where there are fewer items), walk
//     a static list of work items (row block of `rows` rows of x, strip of
//     `cols` columns): CTA c takes items c, c + ctas, c + 2 ctas, ...
//     (item i is row block i / strips, strip i % strips), so each item owns
//     its outputs and no atomics are needed;
//   * one producer warp streams each item's w strip (and noise strip) in
//     boxes of `k_tile` K rows by `cols` columns from 2-D tensor maps
//     (3-D with one plane) into a ring of stages, each guarded by a full
//     and an empty mbarrier, running as many stages ahead as fit (up to
//     8), across items; where N x 4 bytes is no multiple of 16 or an
//     operand is not 16-byte aligned, the producer's lanes copy the boxes
//     with plain loads instead (the tiny ragged shapes);
//   * x is staged in shared memory by the 16 consumer warps as float32,
//     quantized on the way in, K-major (a k's `rows` values side by side),
//     once per row block (a chunk of K at a time where the whole row block
//     does not fit), while the producer's first stages are in flight;
//   * the consumers sum in the earlier kernel's order exactly: warp w takes
//     k = w, w + 16, ... in ascending order (every stage starts at a
//     multiple of 16), each lane one column of a box row (two at 64
//     columns), adding w and the noise with one rounding (__fadd_rn) before
//     its __fmaf_rn products; the 16 partial sums meet in shared memory and
//     are added in warp order;
//   * the epilogue (P strict compares, the closed-form decode, round to
//     nearest even) runs on the float32 sum, one thread per output.
//
// No launch config (kernels/tune.py: rows, cols, k_tile) touches that
// order, so every config, and the earlier one-block-per-tile kernel,
// computes the same bits.  The summation order is not XLA's, so an
// accumulator within float32 rounding of a threshold may land on the other
// side of it: the contract is the fused matmul's code_flips on the
// effective operands pwm(x) and w + noise.  Products and sums are
// __fmaf_rn / __fadd_rn / __fmul_rn so nvcc's --fmad choice cannot change
// the rounding.  Rows of x past M are staged as zeros and their outputs are
// not written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kWarps = 16;  // the K split: fixed, it sets the summation order
constexpr int kConsumers = 32 * kWarps;
constexpr int kThreads = kConsumers + 32;  // + one producer warp
constexpr int kMaxStages = 8;
constexpr int kPartOutputs = kConsumers;  // outputs a partial-sum round covers
constexpr size_t kXBytesMax = 48 * 1024;  // x chunk staged at a time
constexpr int kXBatch = 24;               // x loads a thread keeps in flight
constexpr size_t kSmemMax = 232448;

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

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

inline size_t align128(size_t v) {
  return (v + 127) & ~static_cast<size_t>(127);
}

// The work items and the shared-memory layout, in bytes.
struct Plan {
  int n_strips, n_items;
  int x_cols;        // K columns of x staged at a time (a multiple of k_tile)
  int stages;        // ring stages
  size_t stage_bytes, off_thr, off_part, off_x, off_ring, total;
};

inline Plan make_plan(int rows, int cols, int k_tile, int m_dim, int k_dim,
                      int n_dim, int p, bool noise) {
  Plan g;
  g.n_strips = (n_dim + cols - 1) / cols;
  g.n_items = (m_dim + rows - 1) / rows * g.n_strips;
  const int k_whole = (k_dim + k_tile - 1) / k_tile * k_tile;
  const int x_fit = (int)(kXBytesMax / (4 * (size_t)rows)) / k_tile * k_tile;
  g.x_cols = k_whole < x_fit ? k_whole : x_fit;
  if (g.x_cols < k_tile) g.x_cols = k_tile;
  g.off_thr = 256;  // the 2 x kMaxStages mbarriers first
  g.off_part = align128(g.off_thr + 4 * (size_t)p);
  const int r2 = kPartOutputs / cols < rows ? kPartOutputs / cols : rows;
  g.off_x = align128(g.off_part + 4 * (size_t)kWarps * r2 * cols);
  g.off_ring = align128(g.off_x + 4 * (size_t)rows * g.x_cols);
  g.stage_bytes = 4 * (size_t)k_tile * cols * (noise ? 2 : 1);
  const size_t room = kSmemMax > g.off_ring ? kSmemMax - g.off_ring : 0;
  g.stages = (int)(room / g.stage_bytes);
  if (g.stages > kMaxStages) g.stages = kMaxStages;
  g.total = g.off_ring + (size_t)g.stages * g.stage_bytes;
  return g;
}

// w_map, nz_map: w and the noise as (N, K, 1), a box of kCols columns by
// k_tile K rows (used when `tma`; else the producer's lanes copy).
template <typename T, int kRows, int kCpl, bool kNoise>
__global__ void __launch_bounds__(kThreads, 1) analog_tile_kernel(
    const __grid_constant__ CUtensorMap w_map,
    const __grid_constant__ CUtensorMap nz_map, const T* __restrict__ x,
    const float* __restrict__ w, const float* __restrict__ nz,
    const float* __restrict__ thr, T* __restrict__ out, int m_dim, int k_dim,
    int n_dim, int p, int k_tile, int tma, Pwm q, Decode d, Plan plan) {
  using hopper::mbar_arrive;
  using hopper::mbar_expect_tx;
  using hopper::mbar_init;
  using hopper::mbar_wait;
  constexpr int kCols = 32 * kCpl;
  constexpr int kR2 = kPartOutputs / kCols < kRows ? kPartOutputs / kCols
                                                   : kRows;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // stage loaded
  uint64_t* empty = full + kMaxStages;                 // stage consumed
  float* s_thr = reinterpret_cast<float*>(smem + plan.off_thr);    // P
  float* s_part = reinterpret_cast<float*>(smem + plan.off_part);  // warps x
                                                                   // kR2 x kCols
  float* s_x = reinterpret_cast<float*>(smem + plan.off_x);  // x_cols x kRows
  unsigned char* s_ring = smem + plan.off_ring;
  const int stage_floats = k_tile * kCols;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == kConsumers) {  // the producer's first lane
    for (int s = 0; s < plan.stages; ++s) {
      mbar_init(&full[s], tma ? 1 : 32);
      mbar_init(&empty[s], kWarps);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();  // the barriers are initialized; the stream starts now

  if (warp == kWarps) {
    // the producer: every item's strip, k_tile K rows a stage
    int stage = 0;
    uint32_t phase = 0;
    for (int item = blockIdx.x; item < plan.n_items; item += gridDim.x) {
      const int n0 = (item % plan.n_strips) * kCols;
      for (int k0 = 0; k0 < k_dim; k0 += k_tile) {
        float* sw =
            reinterpret_cast<float*>(s_ring + stage * plan.stage_bytes);
        if (tma) {
          if (lane == 0) {
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_expect_tx(&full[stage], (uint32_t)plan.stage_bytes);
            hopper::tma_load_3d(sw, &w_map, n0, k0, 0, &full[stage]);
            if (kNoise)
              hopper::tma_load_3d(sw + stage_floats, &nz_map, n0, k0, 0,
                                  &full[stage]);
          }
        } else {
          mbar_wait(&empty[stage], phase ^ 1);
          for (int i = lane; i < stage_floats; i += 32) {
            const int k = k0 + i / kCols, n = n0 + i % kCols;
            const bool in = k < k_dim && n < n_dim;
            const size_t at = (size_t)k * n_dim + n;
            sw[i] = in ? __ldg(w + at) : 0.f;
            if (kNoise) sw[stage_floats + i] = in ? __ldg(nz + at) : 0.f;
          }
          mbar_arrive(&full[stage]);  // each lane's stores, released
        }
        if (++stage == plan.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // the consumers.  The thresholds, read only by the epilogue, are loaded
  // now and stored before the first item's epilogue (whose consumer
  // barrier publishes them).
  const float thr_mine = threadIdx.x < p ? thr[threadIdx.x] : 0.f;
  bool thr_stored = false;
  const int n_chunks = (k_dim + plan.x_cols - 1) / plan.x_cols;
  int stage = 0, staged_rb = -1;
  uint32_t phase = 0;
  for (int item = blockIdx.x; item < plan.n_items; item += gridDim.x) {
    const int rb = item / plan.n_strips;
    const int m0 = rb * kRows, n0 = (item % plan.n_strips) * kCols;
    const int rows = min(kRows, m_dim - m0);
    float acc[kRows][kCpl];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCpl; ++c) acc[r][c] = 0.f;

    for (int c0 = 0; c0 < k_dim; c0 += plan.x_cols) {
      const int xc = min(plan.x_cols, k_dim - c0);
      if (n_chunks > 1 || staged_rb != rb) {
        consumers_sync();  // the previous chunk is consumed
        // thread t stages row t % kRows of K columns t / kRows, t / kRows +
        // 32 kWarps / kRows, ...: a warp's stores are 32 consecutive floats
        // (no bank conflict), and kXBatch loads are in flight a thread
        // before the first is used: the PTB crossbar's 16 x 632 values
        // arrive in one round trip (one load at a time, or a bank conflict
        // on every store, holds the stream back by microseconds)
        const int r = threadIdx.x % kRows;
        const T* xr = x + (size_t)(m0 + r) * k_dim + c0;
        constexpr int kStep = kConsumers / kRows;
        for (int kk0 = threadIdx.x / kRows; kk0 < xc; kk0 += kXBatch * kStep) {
          float v[kXBatch];
#pragma unroll
          for (int u = 0; u < kXBatch; ++u) {
            const int kk = kk0 + u * kStep;
            v[u] = (kk < xc && r < rows) ? to_float(xr[kk]) : 0.f;
          }
#pragma unroll
          for (int u = 0; u < kXBatch; ++u) {
            const int kk = kk0 + u * kStep;
            if (kk < xc) s_x[kk * kRows + r] = pwm(v[u], q);
          }
        }
        consumers_sync();
        staged_rb = rb;
      }
      for (int k0 = c0; k0 < c0 + xc; k0 += k_tile) {
        mbar_wait(&full[stage], phase);
        const float* sw =
            reinterpret_cast<const float*>(s_ring + stage * plan.stage_bytes);
        const int kv = min(k_tile, k_dim - k0);
#pragma unroll 4
        for (int kk = warp; kk < kv; kk += kWarps) {
          float wv[kCpl];
#pragma unroll
          for (int c = 0; c < kCpl; ++c) {
            const int i = kk * kCols + lane + 32 * c;
            wv[c] = kNoise ? __fadd_rn(sw[i], sw[stage_floats + i]) : sw[i];
          }
          const float* xr = s_x + (k0 - c0 + kk) * kRows;
#pragma unroll
          for (int r4 = 0; r4 < kRows; r4 += 4) {
            const float4 xv = *reinterpret_cast<const float4*>(xr + r4);
            const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
            for (int e = 0; e < 4; ++e)
#pragma unroll
              for (int c = 0; c < kCpl; ++c)
                acc[r4 + e][c] = __fmaf_rn(xs[e], wv[c], acc[r4 + e][c]);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == plan.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }

    if (!thr_stored) {
      if (threadIdx.x < p) s_thr[threadIdx.x] = thr_mine;
      for (int i = threadIdx.x + kConsumers; i < p; i += kConsumers)
        s_thr[i] = thr[i];
      thr_stored = true;
    }
    // the 16 partial sums meet in shared memory, kR2 rows at a time, and
    // are added in warp order; then the epilogue, one thread per output
#pragma unroll
    for (int rc = 0; rc < kRows; rc += kR2) {
#pragma unroll
      for (int rr = 0; rr < kR2; ++rr)
#pragma unroll
        for (int c = 0; c < kCpl; ++c)
          s_part[(warp * kR2 + rr) * kCols + lane + 32 * c] = acc[rc + rr][c];
      consumers_sync();
      if (threadIdx.x < kR2 * kCols) {
        const int rr = threadIdx.x / kCols, col = threadIdx.x % kCols;
        const int r = rc + rr, n = n0 + col;
        if (r < rows && n < n_dim) {
          float s = s_part[rr * kCols + col];
#pragma unroll
          for (int wi = 1; wi < kWarps; ++wi)
            s = __fadd_rn(s, s_part[(wi * kR2 + rr) * kCols + col]);
          int count = 0;
          for (int j = 0; j < p; ++j) count += (s > s_thr[j]) ? 1 : 0;
          store(out + (size_t)(m0 + r) * n_dim + n, decode(count, d));
        }
      }
      consumers_sync();
    }
  }
}

template <typename T, int kRows, int kCpl, bool kNoise>
int launch(const void* x, const float* w, const float* nz, const float* thr,
           void* out, int m_dim, int k_dim, int n_dim, int p, int k_tile,
           int ctas, const Pwm& q, const Decode& d, cudaStream_t stream) {
  constexpr int kCols = 32 * kCpl;
  const Plan plan =
      make_plan(kRows, kCols, k_tile, m_dim, k_dim, n_dim, p, kNoise);
  if (plan.stages < 2 || ctas < 1) return (int)cudaErrorInvalidValue;
  // TMA boxes where the maps can be encoded: rows of N floats a multiple
  // of 16 bytes, both operands 16-byte aligned, some K
  const int tma = n_dim % 4 == 0 && k_dim > 0 &&
                  reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                  (!kNoise || reinterpret_cast<uintptr_t>(nz) % 16 == 0);
  CUtensorMap w_map, nz_map;
  memset(&w_map, 0, sizeof(w_map));
  memset(&nz_map, 0, sizeof(nz_map));
  if (tma) {
    const uint64_t dims[3] = {(uint64_t)n_dim, (uint64_t)k_dim, 1};
    const uint64_t strides[2] = {(uint64_t)n_dim * 4,
                                 (uint64_t)k_dim * n_dim * 4};
    const uint32_t box[3] = {(uint32_t)kCols, (uint32_t)k_tile, 1};
    if (hopper::tensor_map_3d(w, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, dims,
                              strides, box, &w_map) != 0 ||
        (kNoise && hopper::tensor_map_3d(nz, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                         dims, strides, box, &nz_map) != 0))
      return (int)cudaErrorInvalidValue;
  }
  auto kernel = analog_tile_kernel<T, kRows, kCpl, kNoise>;
  const int set = hopper::func_attribute_at_least<
      analog_tile_kernel<T, kRows, kCpl, kNoise>,
      cudaFuncAttributeMaxDynamicSharedMemorySize>((int)plan.total);
  if (set != 0) return set;
  const int grid = ctas < plan.n_items ? ctas : plan.n_items;
  kernel<<<grid, kThreads, plan.total, stream>>>(
      w_map, nz_map, static_cast<const T*>(x), w, nz, thr,
      static_cast<T*>(out), m_dim, k_dim, n_dim, p, k_tile, tma, q, d, plan);
  return (int)cudaGetLastError();
}

template <typename T, bool kNoise>
int dispatch(const void* x, const float* w, const float* nz,
             const float* thr, void* out, int m_dim, int k_dim, int n_dim,
             int p, int rows, int cols, int k_tile, int ctas, const Pwm& q,
             const Decode& d, cudaStream_t stream) {
#define AT_CASE(R, C)                                                      \
  if (rows == R && cols == 32 * C)                                         \
    return launch<T, R, C, kNoise>(x, w, nz, thr, out, m_dim, k_dim, n_dim, \
                                   p, k_tile, ctas, q, d, stream);
  AT_CASE(4, 1) AT_CASE(8, 1) AT_CASE(16, 1)
  AT_CASE(4, 2) AT_CASE(8, 2) AT_CASE(16, 2)
#undef AT_CASE
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_noise(const void* x, const float* w, const float* nz,
                   const float* thr, void* out, int m_dim, int k_dim,
                   int n_dim, int p, int rows, int cols, int k_tile, int ctas,
                   const Pwm& q, const Decode& d, cudaStream_t stream) {
  if (nz != nullptr)
    return dispatch<T, true>(x, w, nz, thr, out, m_dim, k_dim, n_dim, p, rows,
                             cols, k_tile, ctas, q, d, stream);
  return dispatch<T, false>(x, w, nz, thr, out, m_dim, k_dim, n_dim, p, rows,
                            cols, k_tile, ctas, q, d, stream);
}

}  // namespace

extern "C" {

// x and out are bfloat16 when x_bf16 is nonzero, else float32; nz may be
// null (no read noise).  pwm_on selects the PWM quantization with
// (x_max, recip, step); (mode, m, y0, lsb_l, lsb_r) is the closed-form
// decode; (rows, cols, k_tile) the launch config, k_tile the ring's box
// depth (16, 32, 64 or 128); `ctas` the persistent CTAs (one per SM; fewer
// are launched where there are fewer work items).  Launches on `stream`;
// allocates nothing.  Returns cudaGetLastError(), or cudaErrorInvalidValue
// for a config without a template instance.
int analog_tile_launch(const void* x, const float* w, const float* nz,
                       const float* thr, void* out, int m_dim, int k_dim,
                       int n_dim, int p, int x_bf16, int pwm_on, float x_max,
                       float recip, float step, int mode, int m, float y0,
                       float lsb_l, float lsb_r, int rows, int cols,
                       int k_tile, int ctas, void* stream) {
  if (k_tile < 16 || k_tile > 128 || (k_tile & (k_tile - 1)) ||
      mode < kAffine || mode > kSigned)
    return (int)cudaErrorInvalidValue;
  const Pwm q{pwm_on, x_max, recip, step};
  const Decode d{mode, m, y0, lsb_l, lsb_r};
  cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16)
    return dispatch_noise<__nv_bfloat16>(x, w, nz, thr, out, m_dim, k_dim,
                                         n_dim, p, rows, cols, k_tile, ctas,
                                         q, d, s);
  return dispatch_noise<float>(x, w, nz, thr, out, m_dim, k_dim, n_dim, p,
                               rows, cols, k_tile, ctas, q, d, s);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
