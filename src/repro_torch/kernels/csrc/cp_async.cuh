// Asynchronous 16-byte copies from device memory into shared memory
// (cp.async, sm_80 and later), the ring feed of dense_topk.cu and
// prefill_attention.cu, and decode_attention.cu's query tiles. A copy whose
// source lies outside the tensor passes src_bytes = 0: nothing is read and
// the 16 bytes in shared memory are zero-filled.
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace
