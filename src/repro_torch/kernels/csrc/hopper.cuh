// Hopper building blocks shared by the kernels of this directory: mbarrier
// operations, bulk and tensor (TMA) copies from device memory into shared
// memory (and a stager of small runs built on them), host-side tensor maps
// (2-D with a 128-byte swizzle, 3-D without), warpgroup matrix-multiply
// (wgmma) fences and shared-memory descriptors, the exact three-way
// bfloat16 split of a float32, and the NL-ADC's comparator count and table
// decode on thresholds held in registers.
//
// A tensor map is encoded by the driver's cuTensorMapEncodeTiled, found in
// the loaded driver library with dlopen, so a kernel library needs neither
// libcuda at link time nor a runtime entry-point query.  Maps are cached by
// (address, type, extents, strides, box): serving calls a kernel on the
// same weight or cache tensors over and over, and a map holds only those
// numbers, so a hit is valid whatever the memory holds now.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>
#include <string.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// after one thread has initialized the block's barriers, before any use
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// arrive once and expect `bytes` of asynchronous copies on the barrier
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// one bulk copy of `bytes` (a multiple of 16; both addresses 16-aligned)
// into this CTA's shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// the box of a 3-D tensor map at (c0, c1, c2) into this CTA's shared
// memory (128-aligned), completing on `bar`; out-of-bounds elements are 0
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_addr(bar))
      : "memory");
}

// the box of a 2-D tensor map at (c0, c1) into this CTA's shared memory
// (1024-aligned for a 128-byte swizzle), completing on `bar`;
// out-of-bounds elements are 0
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

// bar.sync on named barrier `id` (1-15; 0 is __syncthreads) by `threads`
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// wgmma: the fence before a warpgroup's first matrix multiply that reads
// registers written since, the commit of the issued ones as a group, and
// the wait until at most kPending groups are in flight
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending)
               : "memory");
}

// The wgmma descriptor of a K-major bfloat16 operand at shared address
// `addr` in the layout a 2-D TMA box of 64 K elements (128 bytes) a row
// writes with the 128-byte swizzle: rows 128 bytes apart, groups of 8 rows
// 1024 bytes apart (the stride byte offset), the swizzle mode in bits
// 62-63.  The K step of 16 elements is +32 bytes on `addr` inside the
// 1024-aligned atom (the hardware swizzles on the address bits).
__device__ __forceinline__ uint64_t kmajor_sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// The exact three-way bfloat16 split of float32 values: v = h1 + h2 + h3,
// each part the next 8 significant bits, by truncation (round toward
// zero), so the top part cannot round up to infinity at +-FLT_MAX.  The
// residuals v - h1 and r1 - h2 are exact float32 subtractions.  Exact for
// |v| >= 2^-110 and for 0 (below, bits under bfloat16's smallest
// subnormal, 2^-133, are lost); +-inf and NaN go whole into h1 (the
// residual v - h1 is NaN there and is replaced by 0).
// kernels/ref.py::split_bf16x3 is the same split in torch.
__device__ __forceinline__ float trunc16(float v) {  // the top 16 bits
  return __uint_as_float(__float_as_uint(v) & 0xFFFF0000u);
}
__device__ __forceinline__ float split_residual(float v) {
  const float r = __fsub_rn(v, trunc16(v));
  return r == r ? r : 0.f;
}

// (lo, hi) -> three bfloat16x2 words, lo in the low half of each
__device__ __forceinline__ void split3_pair(float lo, float hi, uint32_t& p1,
                                            uint32_t& p2, uint32_t& p3) {
  asm("cvt.rz.bf16x2.f32 %0, %1, %2;" : "=r"(p1) : "f"(hi), "f"(lo));
  const float rl = split_residual(lo), rh = split_residual(hi);
  p2 = __byte_perm(__float_as_uint(rl), __float_as_uint(rh), 0x7632);
  const float sl = __fsub_rn(rl, trunc16(rl));
  const float sh = __fsub_rn(rh, trunc16(rh));
  p3 = __byte_perm(__float_as_uint(sl), __float_as_uint(sh), 0x7632);
}

// kP thresholds at `src` into registers: 16-byte loads where `src` is
// 16-byte aligned (kP is a multiple of 4), else one load each.  Lanes that
// share `src` (a (P,) ramp) share each load.
template <int kP>
__device__ __forceinline__ void load_row(float (&t)[kP], const float* src) {
  if (kP % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
#pragma unroll
    for (int v = 0; v < kP / 4; ++v) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(src) + v);
      t[4 * v] = q.x;
      t[4 * v + 1] = q.y;
      t[4 * v + 2] = q.z;
      t[4 * v + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kP; ++k) t[k] = __ldg(src + k);
  }
}

// Brings up to kMax runs of floats from device memory into this CTA's
// shared memory (16-byte aligned destinations) in one device round trip: a
// run 16-byte aligned at both ends goes by one bulk copy on `bar`, issued
// by thread 0; any other run is copied by every thread with plain loads.
// Every thread makes the same calls in the same order:
//
//   Strips<2> st;  st.add(dst, src, n) for each run
//   st.issue(bar);      thread 0: initialise `bar`, issue the bulk copies
//   ...                 the caller's own loads into registers
//   st.land(bar);       the plain copies, one barrier, the bulk copies' wait
//
// so the caller's loads and the copies are in flight together.
template <int kMax>
struct Strips {
  float* dst[kMax];
  const float* src[kMax];
  int n[kMax];
  bool bulk[kMax];
  int count = 0;
  uint32_t tx = 0;

  __device__ __forceinline__ void add(float* d, const float* s, int floats) {
    dst[count] = d;
    src[count] = s;
    n[count] = floats;
    bulk[count] = floats > 0 && floats % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(s) % 16 == 0;
    if (bulk[count]) tx += 4u * floats;
    ++count;
  }

  __device__ __forceinline__ void issue(uint64_t* bar) const {
    if (threadIdx.x != 0 || tx == 0) return;
    mbar_init(bar, 1);
    fence_mbar_init();
    mbar_expect_tx(bar, tx);
#pragma unroll
    for (int i = 0; i < kMax; ++i)
      if (i < count && bulk[i]) bulk_load(dst[i], src[i], 4u * n[i], bar);
  }

  __device__ __forceinline__ void land(uint64_t* bar) const {
#pragma unroll
    for (int i = 0; i < kMax; ++i) {
      if (i >= count || bulk[i]) continue;
      for (int u = threadIdx.x; u < n[i]; u += blockDim.x)
        dst[i][u] = __ldg(src[i] + u);
    }
    __syncthreads();
    if (tx) mbar_wait(bar, 0);
  }
};

// Copies row `src` of kP thresholds (shared memory) into registers, lane q
// starting at threshold q mod kP: rows kP floats apart then spread over the
// banks whatever kP is (32 columns at a pitch of 32 would share one).
template <int kP>
__device__ __forceinline__ void load_rotated(float (&t)[kP], const float* src,
                                             int q) {
  q %= kP;
#pragma unroll
  for (int k = 0; k < kP; ++k) {
    const int i = k + q;
    t[k] = src[i < kP ? i : i - kP];
  }
}

// -1 where x > t, else 0 (NaN compares false): one set.gt, so a count is a
// subtraction a compare
__device__ __forceinline__ int gt_mask(float x, float t) {
  int m;
  asm("set.gt.s32.f32 %0, %1, %2;" : "=r"(m) : "f"(x), "f"(t));
  return m;
}

// #{k : x > t[k]} over kP thresholds in registers: each compare is one
// set.gt (-1 or 0; NaN compares false), summed as a tree in groups of 8, so
// no compare waits on the one before it.  The count is an integer sum, so it
// does not depend on the order of t.
template <int kP>
__device__ __forceinline__ int count_gt(float x, const float (&t)[kP]) {
  int total = 0;
#pragma unroll
  for (int g = 0; g < kP; g += 8) {
    int m[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      m[i] = 0;
      if (g + i < kP)
        asm("set.gt.s32.f32 %0, %1, %2;" : "=r"(m[i]) : "f"(x), "f"(t[g + i]));
    }
#pragma unroll
    for (int w = 1; w < 8; w *= 2)
#pragma unroll
      for (int i = 0; i + w < 8; i += 2 * w) m[i] += m[i + w];
    total += m[0];
  }
  return -total;
}

// y[n], n in [0, kP], from a table held one entry a lane (y_lane =
// y[min(lane, kP)]) and y_last = y[kP]: a warp shuffle, so every lane of the
// warp must call it.
template <int kP>
__device__ __forceinline__ float table_at(float y_lane, float y_last, int n) {
  static_assert(kP <= 32, "a warp holds at most 33 table entries");
  const float y = __shfl_sync(0xffffffffu, y_lane, n & 31);
  return (kP == 32 && n == 32) ? y_last : y;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

struct MapKey {
  const void* base;
  int type, rank, swizzle;
  uint64_t dims[3], strides[2];
  uint32_t box[3];
};

// The tensor map of `base` of rank 2 or 3 (dims innermost first; byte
// strides of dims 1 and 2) with a `box` and a swizzle mode, out-of-bounds
// reads as zeros.  Returns 0, or a nonzero CUresult.
inline int tensor_map(int rank, const void* base, CUtensorMapDataType type,
                      const uint64_t* dims, const uint64_t* strides,
                      const uint32_t* box, CUtensorMapSwizzle swizzle,
                      CUtensorMap* out) {
  constexpr int kCache = 256;
  static MapKey keys[kCache];
  static CUtensorMap maps[kCache];
  static int n_cached = 0, next = 0;
  MapKey key;
  memset(&key, 0, sizeof(key));
  key.base = base;
  key.type = static_cast<int>(type);
  key.rank = rank;
  key.swizzle = static_cast<int>(swizzle);
  for (int i = 0; i < rank; ++i) key.dims[i] = dims[i], key.box[i] = box[i];
  for (int i = 0; i < rank - 1; ++i) key.strides[i] = strides[i];
  // a serving step asks for its layers' maps in the order it first made
  // them, so the scan starts after the last hit
  static int last = -1;
  for (int n = 1; n <= n_cached; ++n) {
    const int i = (last + n) % n_cached;
    if (memcmp(&keys[i], &key, sizeof(key)) == 0) {
      last = i;
      *out = maps[i];
      return 0;
    }
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t d[3] = {key.dims[0], key.dims[1], key.dims[2]};
  const cuuint64_t s[2] = {key.strides[0], key.strides[1]};
  const cuuint32_t b[3] = {key.box[0], key.box[1], key.box[2]};
  const cuuint32_t e[3] = {1, 1, 1};
  CUtensorMap map;
  const CUresult res = encode(
      &map, type, static_cast<cuuint32_t>(rank), const_cast<void*>(base), d,
      s, b, e, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return static_cast<int>(res);
  keys[next] = key;
  maps[next] = map;
  last = next;
  next = (next + 1) % kCache;
  if (n_cached < kCache) ++n_cached;
  *out = map;
  return 0;
}

// The 3-D tensor map of `base` with a `box`, no swizzle.
inline int tensor_map_3d(const void* base, CUtensorMapDataType type,
                         const uint64_t dims[3], const uint64_t strides[2],
                         const uint32_t box[3], CUtensorMap* out) {
  return tensor_map(3, base, type, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_NONE, out);
}

// The 2-D tensor map of `base` (dims innermost first; the byte stride of
// dim 1) with a `box` of at most 128 bytes a row, the 128-byte swizzle:
// the layout a wgmma descriptor reads (kmajor_sw128_desc).
inline int tensor_map_2d_sw128(const void* base, CUtensorMapDataType type,
                               const uint64_t dims[2], uint64_t stride,
                               const uint32_t box[2], CUtensorMap* out) {
  return tensor_map(2, base, type, dims, &stride, box,
                    CU_TENSOR_MAP_SWIZZLE_128B, out);
}

// Sets attribute kAttr of kernel kKernel on the current device to `value`
// unless an earlier call there set it at least as high, so a launch that
// needs no more than an earlier one makes no runtime call.  Returns a
// cudaError_t.
template <auto kKernel, cudaFuncAttribute kAttr>
inline int func_attribute_at_least(int value) {
  constexpr int kDevices = 64;
  static int set[kDevices] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (value <= set[dev]) return 0;
  err = cudaFuncSetAttribute(kKernel, kAttr, value);
  if (err != cudaSuccess) return static_cast<int>(err);
  set[dev] = value;
  return 0;
}

// the SMs of the current device
inline int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0)
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev];
}

}  // namespace hopper
