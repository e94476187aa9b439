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
// either one (P,) ramp shared by every column or one row of an (H, P)
// per-column matrix (the threshold-bank layout).  Every compare runs over
// all P thresholds, whatever their order (programmed ramps are noisy), and a
// NaN input counts 0.
//
// Bound on this card: at the main path's shape (B 16, H 2016, P 32, the
// 5-bit ADC) one call reads gates 16 x 8064 and c 16 x 2016 and writes h'
// and c', 0.9 MB (0.27 us at 3.35 TB/s); the banked layout adds two (H, P)
// matrices, 0.5 MB (1.42 MB, 0.42 us).  The 5 x 32 compares an element are
// 5.3 M operations, 0.08 us at 67 TFLOP/s.  Both are far below a launch, so
// what bounds a call is latency: the launch, the device-memory round trips
// before the first compare, and each thread's chain of compares.  The
// design pays one round trip, reads every byte once and keeps the chain
// short:
//
//   * a CTA owns a strip of `cols` columns (a multiple of 16) over `groups`
//     row groups, each thread one column and kRows batch rows (g, g +
//     groups, ...), so a half-warp reads 64 contiguous bytes of a gate row
//     and the CTA covers groups x kRows batch rows: all of B at the main
//     paths' shapes, so each threshold byte is read from device memory once
//     a call, not once per batch row;
//   * every load is issued before the first compare: the thread's gate and
//     c values; a (P,) ramp straight into registers (one broadcast line,
//     16-byte loads); the y tables one entry a lane (decoded by a warp
//     shuffle, y[P] beside it); and, in the banked instance, the strip's
//     rows of each (H, P) matrix (one contiguous run of cols x P floats) by
//     one bulk copy on an mbarrier, issued by thread 0 first (the lanes
//     copy a run with plain loads where it is not 16-byte aligned), after
//     which each thread copies its column's row into registers, each lane
//     starting at its own threshold so that 32 rows of 32 floats do not
//     share a bank;
//   * P is a template constant for the 3-, 4- and 5-bit ADCs (P = 8, 16,
//     32), so the 5 x P compares unroll, each one set.gt summed as a tree
//     (no compare waits on the one before it); any other P takes one
//     run-time instance that reads the thresholds and tables from device
//     memory.
//
// The (P,) instance has no shared memory and no barrier.  Staging the (P,)
// ramps the same way as the (H, P) strips, or reading the (H, P) rows
// straight into registers (each lane a 128-byte row), was slower on the
// H100 than this split.  The products are written as __fmul_rn /
// __fmaf_rn so nvcc's --fmad choice cannot change the rounding.  A count is
// an integer sum, so its order does not matter, and every launch config
// gives the same bits.
//
// Launch config (kernels/tune.py): (rows, threads) = rows a thread takes
// (1, 2 or 4: template instances) and threads a CTA may use (a multiple of
// 32, at most 512); the wrapper (kernels/lstm_cell.py::launch_geometry)
// turns them into (cols, groups) and the grid, and passes those here.  The
// default (1, 256) gives PTB's (16, 2016) 126 CTAs of 16 x 16: one wave of
// the 132 SMs.

#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kMaxThreads = 512;

struct Tail {
  const float* gates;
  const float* c;
  const float* sig_thr;
  const float* sig_y;
  const float* tanh_thr;
  const float* tanh_y;
  float* h_out;
  float* c_out;
  int b_dim, h_dim, p;
  int sig_banked, tanh_banked;  // 1: an (H, P) matrix; 0: a (P,) ramp
  int cols, groups;             // a CTA: `groups` row groups x `cols` columns
};

// #{k : x > t[k]} over a run-time p
__device__ __forceinline__ int count_from(float x, const float* t, int p) {
  int n = 0;
  for (int k = 0; k < p; ++k) n += (x > __ldg(t + k)) ? 1 : 0;
  return n;
}

// kBanked: at least one ramp is an (H, P) matrix, whose strip is staged
template <int kP, int kRows, bool kBanked>
__global__ void __launch_bounds__(kMaxThreads)
    lstm_gates_kernel(const Tail a) {
  const int p = kP ? kP : a.p;
  const int lane = threadIdx.x % 32;
  const int j0 = blockIdx.x * a.cols;
  const int col = threadIdx.x % a.cols;
  const int group = threadIdx.x / a.cols;
  const int j = j0 + col;
  const bool live = group < a.groups && j < a.h_dim;
  const int b0 = blockIdx.y * a.groups * kRows + group;

  // the strip's rows of each (H, P) matrix are one contiguous run of
  // cols x P floats: bulk copies into shared memory, issued first
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t bar;
  const int cols_here = min(a.cols, a.h_dim - j0);
  float* s_sig = smem;
  float* s_tanh = smem + (a.sig_banked ? a.cols * p : 0);
  hopper::Strips<2> st;
  static_assert(kP > 0 || !kBanked, "the staged strips are P-wide rows");
  if constexpr (kBanked) {
    st.add(s_sig, a.sig_thr + (size_t)j0 * kP,
           a.sig_banked ? cols_here * kP : 0);
    st.add(s_tanh, a.tanh_thr + (size_t)j0 * kP,
           a.tanh_banked ? cols_here * kP : 0);
    st.issue(&bar);
  }

  // this thread's gate and c loads, in flight before anything waits
  float gf[kRows], ga[kRows], gi[kRows], go[kRows], cc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int b = b0 + r * a.groups;
    gf[r] = ga[r] = gi[r] = go[r] = cc[r] = 0.f;
    if (live && b < a.b_dim) {
      const float* g = a.gates + (size_t)b * 4 * a.h_dim + j;
      gf[r] = __ldg(g);
      ga[r] = __ldg(g + a.h_dim);
      gi[r] = __ldg(g + 2 * a.h_dim);
      go[r] = __ldg(g + 3 * a.h_dim);
      cc[r] = __ldg(a.c + (size_t)b * a.h_dim + j);
    }
  }
  const size_t row = (size_t)(live ? j : j0) * p;  // a column's (H, P) row
  const float* ts = a.sig_thr + (a.sig_banked ? row : 0);
  const float* tt = a.tanh_thr + (a.tanh_banked ? row : 0);

  if constexpr (kP > 0) {
    // a (P,) ramp straight into registers (one broadcast line); the y
    // tables one entry a lane
    float rs[kP], rt[kP];
    if (!a.sig_banked) hopper::load_row<kP>(rs, ts);
    if (!a.tanh_banked) hopper::load_row<kP>(rt, tt);
    const int yl = lane < kP ? lane : kP;
    const float ys = __ldg(a.sig_y + yl), yt = __ldg(a.tanh_y + yl);
    const float ys_last = __ldg(a.sig_y + kP), yt_last = __ldg(a.tanh_y + kP);
    if constexpr (kBanked) {
      st.land(&bar);
      const int c = live ? col : 0;
      if (a.sig_banked) hopper::load_rotated<kP>(rs, s_sig + c * kP, c);
      if (a.tanh_banked) hopper::load_rotated<kP>(rt, s_tanh + c * kP, c);
    }
    // every lane runs every row (the decode is a warp shuffle); only the
    // stores are masked
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int b = b0 + r * a.groups;
      const float f = hopper::table_at<kP>(ys, ys_last,
                                           hopper::count_gt<kP>(gf[r], rs));
      const float av = hopper::table_at<kP>(yt, yt_last,
                                            hopper::count_gt<kP>(ga[r], rt));
      const float i = hopper::table_at<kP>(ys, ys_last,
                                           hopper::count_gt<kP>(gi[r], rs));
      const float o = hopper::table_at<kP>(ys, ys_last,
                                           hopper::count_gt<kP>(go[r], rs));
      const float c_new = __fmaf_rn(f, cc[r], __fmul_rn(i, av));
      const float t = hopper::table_at<kP>(yt, yt_last,
                                           hopper::count_gt<kP>(c_new, rt));
      if (live && b < a.b_dim) {
        const size_t e = (size_t)b * a.h_dim + j;
        a.h_out[e] = __fmul_rn(o, t);
        a.c_out[e] = c_new;
      }
    }
  } else {
    if (!live) return;
    for (int r = 0; r < kRows; ++r) {
      const int b = b0 + r * a.groups;
      if (b >= a.b_dim) break;
      const float f = __ldg(a.sig_y + count_from(gf[r], ts, p));
      const float av = __ldg(a.tanh_y + count_from(ga[r], tt, p));
      const float i = __ldg(a.sig_y + count_from(gi[r], ts, p));
      const float o = __ldg(a.sig_y + count_from(go[r], ts, p));
      const float c_new = __fmaf_rn(f, cc[r], __fmul_rn(i, av));
      const float t = __ldg(a.tanh_y + count_from(c_new, tt, p));
      const size_t e = (size_t)b * a.h_dim + j;
      a.h_out[e] = __fmul_rn(o, t);
      a.c_out[e] = c_new;
    }
  }
}

using Kernel = void (*)(const Tail);

template <int kP, bool kBanked>
Kernel pick_rows(int rows) {
  if (rows == 1) return lstm_gates_kernel<kP, 1, kBanked>;
  if (rows == 2) return lstm_gates_kernel<kP, 2, kBanked>;
  if (rows == 4) return lstm_gates_kernel<kP, 4, kBanked>;
  return nullptr;
}

// P = 8, 16, 32 (the 3-, 4- and 5-bit ADCs) are template instances, the
// banked layout among them its own; any other P takes the run-time one
Kernel pick(int p, int rows, bool banked) {
  if (p == 8)
    return banked ? pick_rows<8, true>(rows) : pick_rows<8, false>(rows);
  if (p == 16)
    return banked ? pick_rows<16, true>(rows) : pick_rows<16, false>(rows);
  if (p == 32)
    return banked ? pick_rows<32, true>(rows) : pick_rows<32, false>(rows);
  return pick_rows<0, false>(rows);
}

}  // namespace

extern "C" {

// One launch over a grid of (ceil(H / cols), grid_y) CTAs, each of `groups`
// row groups x `cols` columns, each thread taking `rows` batch rows
// (kernels/lstm_cell.py::launch_geometry computes all four).  sig_stride /
// tanh_stride: P for an (H, P) matrix, 0 for a (P,) ramp.  Launches on
// `stream`; allocates nothing.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a geometry out of range.
int lstm_gates_launch(const float* gates, const float* c,
                      const float* sig_thr, const float* sig_y,
                      const float* tanh_thr, const float* tanh_y,
                      float* h_out, float* c_out, int b_dim, int h_dim, int p,
                      int sig_stride, int tanh_stride, int rows, int cols,
                      int groups, int grid_y, void* stream) {
  const bool banked =
      (p == 8 || p == 16 || p == 32) && (sig_stride || tanh_stride);
  const Kernel kernel = pick(p, rows, banked);
  if (kernel == nullptr || p < 1 || cols < 1 || groups < 1 ||
      cols * groups > kMaxThreads || grid_y < 1 || grid_y > 65535)
    return (int)cudaErrorInvalidValue;
  const Tail a{gates, c, sig_thr, sig_y, tanh_thr, tanh_y, h_out, c_out,
               b_dim, h_dim, p, sig_stride ? 1 : 0, tanh_stride ? 1 : 0,
               cols, groups};
  const dim3 grid((h_dim + cols - 1) / cols, grid_y);
  // whole warps: the decode is a warp shuffle
  const int threads = (cols * groups + 31) / 32 * 32;
  // the staged strips: cols x P floats for each (H, P) matrix
  const size_t smem =
      banked ? sizeof(float) * cols * p *
                   ((sig_stride ? 1 : 0) + (tanh_stride ? 1 : 0))
             : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
