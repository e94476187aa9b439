// The launch floor: one block that writes one word.
//
// Not a port of a TPU kernel.  It is built and launched as every kernel of
// this directory is (nvcc for sm_90a, a plain C interface, ctypes), so its
// device time is what a launch of the smallest kernel costs on this card:
// the floor beside which the tiny cases of the elementwise kernels (the MoE
// router's (4, 64) NL-ADC, the KWS LSTM tail) are read.  It is no bound.

#include <cuda_runtime.h>

namespace {

__global__ void launch_floor_kernel(int* out) {
  if (threadIdx.x == 0) *out = 1;
}

}  // namespace

extern "C" {

// Writes 1 to *out on `stream`.  Returns cudaGetLastError().
int launch_floor_launch(int* out, void* stream) {
  launch_floor_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(out);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
