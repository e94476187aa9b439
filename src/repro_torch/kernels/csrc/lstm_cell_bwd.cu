// Backward of the fused LSTM elementwise tail (paper Eq. 5 / Fig. S6) for
// sm_90a: the straight-through gradients of Alg. 1.
//
// Replaces the hand-written backward of the TPU kernel's custom_vjp,
// src/repro/core/backend.py:279-307 (plain jnp there, one XLA fusion a
// step under jax.jit).  Per element (b, j), j < H, of packed gates (B, 4H)
// in the order [f|a|i|o], with cotangents ct_h = dL/dh' and ct_c = dL/dc':
//
//   rematerialize, exactly as csrc/lstm_cell.cu computes them:
//     f, i, o = sigmoid NL-ADC of the f, i, o gates;  a = tanh NL-ADC
//     c'      = fma(f, c, i*a);  t = tanh NL-ADC of c'
//   then chain five straight-through estimators, ste(x, ct) = ct * g'(x)
//   on the ramp's domain [lo, hi] (inclusive) and 0 outside:
//     d_o  = ste_sig(g_o, ct_h * t)
//     d_c' = ct_c + ste_tanh(c', ct_h * o)
//     d_f  = ste_sig(g_f, d_c' * c);  d_i = ste_sig(g_i, d_c' * a)
//     d_a  = ste_tanh(g_a, d_c' * i);  d_c = d_c' * f
//   and write d_gates = [d_f|d_a|d_i|d_o] (B, 4H) and d_c (B, H).
//
// g' is torch's own arithmetic on the card: sigmoid s = 1 / (1 + expf(-x)),
// g' = s * (1 - s); tanh t = tanhf(x), g' = 1 - t * t; the accurate expf
// and tanhf (no fast-math intrinsics; the build passes no fast-math flag)
// and every product and sum written as __fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn, so nvcc's --fmad choice cannot change a rounding.  The plain
// version (kernels/lstm_cell.py::lstm_gates_bwd_plain) computes the same
// operations in the same order.
//
// Bound on this card: at the PTB shape (B 16, H 2016, P 32) one call reads
// gates, c, ct_h and ct_c (16 x 14112 floats) and writes d_gates and d_c
// (16 x 10080), 1.5 MB (0.46 us at 3.35 TB/s; banked adds two (H, P)
// strips, 0.5 MB).  Like the forward it is bound by latency, and it keeps
// the forward's design: one CTA per strip of columns over all B rows, so
// each threshold byte is read once a call; every load issued before the
// first compare; a (P,) ramp straight into registers, (H, P) strips by one
// bulk copy (hopper::Strips); P = 8, 16, 32 as template constants with a
// warp-shuffle decode, any other P on a run-time instance.  The launch
// geometry is the forward's default (kernels/lstm_cell.py::launch_geometry
// at 1 row, 256 threads), with no tune knob.
//
// `codes`, when not null, receives the five rematerialized counts as int32
// (5, B, H) in the order f, a, i, o, c': the evidence that the backward
// compares exactly as the forward did.

#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kMaxThreads = 512;

struct TailBwd {
  const float* gates;
  const float* c;
  const float* sig_thr;
  const float* sig_y;
  const float* tanh_thr;
  const float* tanh_y;
  const float* ct_h;
  const float* ct_c;
  float* d_gates;
  float* d_c;
  int* codes;                   // null, or (5, B, H)
  int b_dim, h_dim, p;
  int sig_banked, tanh_banked;  // 1: an (H, P) matrix; 0: a (P,) ramp
  int cols, groups;             // a CTA: `groups` row groups x `cols` columns
  float sig_lo, sig_hi, tanh_lo, tanh_hi;
};

// #{k : x > t[k]} over a run-time p
__device__ __forceinline__ int count_from(float x, const float* t, int p) {
  int n = 0;
  for (int k = 0; k < p; ++k) n += (x > __ldg(t + k)) ? 1 : 0;
  return n;
}

// g' of the sigmoid ramp on [lo, hi], else 0 (NaN is outside)
__device__ __forceinline__ float sigmoid_grad(float x, float lo, float hi) {
  const float s = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
  const float g = __fmul_rn(s, __fsub_rn(1.f, s));
  return (x >= lo && x <= hi) ? g : 0.f;
}

// g' of the tanh ramp on [lo, hi], else 0
__device__ __forceinline__ float tanh_grad(float x, float lo, float hi) {
  const float t = tanhf(x);
  const float g = __fsub_rn(1.f, __fmul_rn(t, t));
  return (x >= lo && x <= hi) ? g : 0.f;
}

// the STE chain of one element from its rematerialized values
struct Grads {
  float df, da, di, d_o, dc;
};

__device__ __forceinline__ Grads chain(const TailBwd& a, float gf, float ga,
                                       float gi, float go, float cc, float f,
                                       float av, float i, float o,
                                       float c_new, float t, float cth,
                                       float ctc) {
  Grads r;
  r.d_o = __fmul_rn(__fmul_rn(cth, t), sigmoid_grad(go, a.sig_lo, a.sig_hi));
  const float dcn = __fadd_rn(
      ctc,
      __fmul_rn(__fmul_rn(cth, o), tanh_grad(c_new, a.tanh_lo, a.tanh_hi)));
  r.df = __fmul_rn(__fmul_rn(dcn, cc), sigmoid_grad(gf, a.sig_lo, a.sig_hi));
  r.di = __fmul_rn(__fmul_rn(dcn, av), sigmoid_grad(gi, a.sig_lo, a.sig_hi));
  r.da = __fmul_rn(__fmul_rn(dcn, i), tanh_grad(ga, a.tanh_lo, a.tanh_hi));
  r.dc = __fmul_rn(dcn, f);
  return r;
}

__device__ __forceinline__ void store(const TailBwd& a, int b, int j,
                                      const Grads& g, int nf, int na, int ni,
                                      int no, int nc) {
  float* dg = a.d_gates + (size_t)b * 4 * a.h_dim + j;
  dg[0] = g.df;
  dg[a.h_dim] = g.da;
  dg[2 * a.h_dim] = g.di;
  dg[3 * a.h_dim] = g.d_o;
  const size_t e = (size_t)b * a.h_dim + j;
  a.d_c[e] = g.dc;
  if (a.codes != nullptr) {
    const size_t plane = (size_t)a.b_dim * a.h_dim;
    a.codes[e] = nf;
    a.codes[plane + e] = na;
    a.codes[2 * plane + e] = ni;
    a.codes[3 * plane + e] = no;
    a.codes[4 * plane + e] = nc;
  }
}

// kBanked: at least one ramp is an (H, P) matrix, whose strip is staged
template <int kP, bool kBanked>
__global__ void __launch_bounds__(kMaxThreads)
    lstm_gates_bwd_kernel(const TailBwd a) {
  const int p = kP ? kP : a.p;
  const int lane = threadIdx.x % 32;
  const int j0 = blockIdx.x * a.cols;
  const int col = threadIdx.x % a.cols;
  const int group = threadIdx.x / a.cols;
  const int j = j0 + col;
  const int b = blockIdx.y * a.groups + group;
  const bool live = group < a.groups && j < a.h_dim && b < a.b_dim;

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

  // this thread's element: four gates, c and the two cotangents
  float gf = 0.f, ga = 0.f, gi = 0.f, go = 0.f, cc = 0.f, cth = 0.f,
        ctc = 0.f;
  if (live) {
    const float* g = a.gates + (size_t)b * 4 * a.h_dim + j;
    const size_t e = (size_t)b * a.h_dim + j;
    gf = __ldg(g);
    ga = __ldg(g + a.h_dim);
    gi = __ldg(g + 2 * a.h_dim);
    go = __ldg(g + 3 * a.h_dim);
    cc = __ldg(a.c + e);
    cth = __ldg(a.ct_h + e);
    ctc = __ldg(a.ct_c + e);
  }
  const size_t row = (size_t)(j < a.h_dim ? j : j0) * p;
  const float* ts = a.sig_thr + (a.sig_banked ? row : 0);
  const float* tt = a.tanh_thr + (a.tanh_banked ? row : 0);

  if constexpr (kP > 0) {
    float rs[kP], rt[kP];
    if (!a.sig_banked) hopper::load_row<kP>(rs, ts);
    if (!a.tanh_banked) hopper::load_row<kP>(rt, tt);
    const int yl = lane < kP ? lane : kP;
    const float ys = __ldg(a.sig_y + yl), yt = __ldg(a.tanh_y + yl);
    const float ys_last = __ldg(a.sig_y + kP), yt_last = __ldg(a.tanh_y + kP);
    if constexpr (kBanked) {
      st.land(&bar);
      const int c = j < a.h_dim ? col : 0;
      if (a.sig_banked) hopper::load_rotated<kP>(rs, s_sig + c * kP, c);
      if (a.tanh_banked) hopper::load_rotated<kP>(rt, s_tanh + c * kP, c);
    }
    // every lane decodes (a warp shuffle); only the stores are masked
    const int nf = hopper::count_gt<kP>(gf, rs);
    const int na = hopper::count_gt<kP>(ga, rt);
    const int ni = hopper::count_gt<kP>(gi, rs);
    const int no = hopper::count_gt<kP>(go, rs);
    const float f = hopper::table_at<kP>(ys, ys_last, nf);
    const float av = hopper::table_at<kP>(yt, yt_last, na);
    const float i = hopper::table_at<kP>(ys, ys_last, ni);
    const float o = hopper::table_at<kP>(ys, ys_last, no);
    const float c_new = __fmaf_rn(f, cc, __fmul_rn(i, av));
    const int nc = hopper::count_gt<kP>(c_new, rt);
    const float t = hopper::table_at<kP>(yt, yt_last, nc);
    if (live)
      store(a, b, j, chain(a, gf, ga, gi, go, cc, f, av, i, o, c_new, t, cth,
                           ctc),
            nf, na, ni, no, nc);
  } else {
    if (!live) return;
    const int nf = count_from(gf, ts, p), na = count_from(ga, tt, p);
    const int ni = count_from(gi, ts, p), no = count_from(go, ts, p);
    const float f = __ldg(a.sig_y + nf), av = __ldg(a.tanh_y + na);
    const float i = __ldg(a.sig_y + ni), o = __ldg(a.sig_y + no);
    const float c_new = __fmaf_rn(f, cc, __fmul_rn(i, av));
    const int nc = count_from(c_new, tt, p);
    const float t = __ldg(a.tanh_y + nc);
    store(a, b, j,
          chain(a, gf, ga, gi, go, cc, f, av, i, o, c_new, t, cth, ctc), nf,
          na, ni, no, nc);
  }
}

using Kernel = void (*)(const TailBwd);

// P = 8, 16, 32 (the 3-, 4- and 5-bit ADCs) are template instances, the
// banked layout among them its own; any other P takes the run-time one
Kernel pick(int p, bool banked) {
  if (p == 8)
    return banked ? lstm_gates_bwd_kernel<8, true>
                  : lstm_gates_bwd_kernel<8, false>;
  if (p == 16)
    return banked ? lstm_gates_bwd_kernel<16, true>
                  : lstm_gates_bwd_kernel<16, false>;
  if (p == 32)
    return banked ? lstm_gates_bwd_kernel<32, true>
                  : lstm_gates_bwd_kernel<32, false>;
  return lstm_gates_bwd_kernel<0, false>;
}

}  // namespace

extern "C" {

// One launch over a grid of (ceil(H / cols), grid_y) CTAs, each of `groups`
// row groups x `cols` columns, a thread one (row, column) element
// (kernels/lstm_cell.py::launch_geometry at one row a thread).  sig_stride /
// tanh_stride: P for an (H, P) matrix, 0 for a (P,) ramp.  `codes` may be
// null.  Launches on `stream`; allocates nothing.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a geometry out of range.
int lstm_gates_bwd_launch(const float* gates, const float* c,
                          const float* sig_thr, const float* sig_y,
                          const float* tanh_thr, const float* tanh_y,
                          const float* ct_h, const float* ct_c,
                          float* d_gates, float* d_c, int* codes, int b_dim,
                          int h_dim, int p, int sig_stride, int tanh_stride,
                          int cols, int groups, int grid_y, float sig_lo,
                          float sig_hi, float tanh_lo, float tanh_hi,
                          void* stream) {
  const bool banked =
      (p == 8 || p == 16 || p == 32) && (sig_stride || tanh_stride);
  const Kernel kernel = pick(p, banked);
  if (p < 1 || cols < 1 || groups < 1 || cols * groups > kMaxThreads ||
      grid_y < 1 || grid_y > 65535)
    return (int)cudaErrorInvalidValue;
  const TailBwd a{gates, c, sig_thr, sig_y, tanh_thr, tanh_y, ct_h, ct_c,
                  d_gates, d_c, codes, b_dim, h_dim, p, sig_stride ? 1 : 0,
                  tanh_stride ? 1 : 0, cols, groups, sig_lo, sig_hi, tanh_lo,
                  tanh_hi};
  const dim3 grid((h_dim + cols - 1) / cols, grid_y);
  // whole warps: the decode is a warp shuffle
  const int threads = (cols * groups + 31) / 32 * 32;
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
