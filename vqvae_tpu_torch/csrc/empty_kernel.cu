// A kernel that does nothing, launched the way the nearest-code kernels are
// (ctypes, the caller's stream). Its time is the launch floor of the card: no
// hand-written kernel can take less, whatever its bound says. Only the smoke
// script's timing phase launches it.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// Returns the CUDA error code of the launch (0 = success).
int vq_empty_kernel(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
