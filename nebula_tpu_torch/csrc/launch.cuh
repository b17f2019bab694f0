// Launch geometry shared by the kernels: ceil division, the card's SM
// count, and the resident blocks of a persistent grid whose staged route
// takes dynamic shared memory (relax.cu, bfs.cu).
#pragma once

#include <cuda_runtime.h>

namespace {

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    sms = v > 0 ? v : 132;
  }
  return sms;
}

// A kernel's opt-in shared memory and its resident blocks an SM at the
// last stage size it launched with: host queries kept off the launch path.
struct Resident {
  int optin = 0;
  long long bytes = -1;
  int blocks = 1;
};

// *grid = the blocks of `kern` (`threads` a block, `bytes` of dynamic
// shared memory: past 48 KB only after opting in to the card's maximum,
// done the first time) that the card holds at once.  Returns a CUDA
// error code, cudaErrorInvalidValue where `bytes` exceeds the maximum.
template <typename Kernel>
int resident_grid(Kernel kern, int threads, long long bytes, Resident& res,
                  long long* grid) {
  if (bytes > 0 && res.optin == 0) {
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e != cudaSuccess) return (int)e;
    res.optin = optin;
  }
  if (bytes > 0 && bytes > res.optin) return (int)cudaErrorInvalidValue;
  if (res.bytes != bytes) {
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kern, threads,
                                                  (size_t)bytes);
    res.blocks = b > 0 ? b : 1;
    res.bytes = bytes;
  }
  *grid = (long long)num_sms() * res.blocks;
  return 0;
}

}  // namespace
