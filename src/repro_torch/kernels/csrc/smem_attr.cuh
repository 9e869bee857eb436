// A kernel's dynamic shared memory above 48 KB must be allowed with
// cudaFuncSetAttribute, and the attribute belongs to the device that was
// current when it was set. Each launch site keeps one flag per device (a
// static array of its own, so per kernel instantiation): the first launch
// on a device sets the attribute there, and every launch makes one
// cudaGetDevice call besides, which CUDA-graph capture allows. Without the
// per-device flag a kernel first launched on cuda:0 would refuse to launch
// on another card (the sharded backends place shards on every card).
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDevices = 64;

template <typename Kernel>
void allow_smem(bool (&done)[kMaxDevices], Kernel kernel, int bytes) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices || !done[dev]) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (dev < kMaxDevices) done[dev] = true;
  }
}

}  // namespace
