// The wide-head paths of B2 (decode_attention.cu, decode_wide_kernel) and
// B3 (prefill_attention.cu, prefill_wide_kernel): attention at a head dim
// above 256, the widest instance of either kernel. They take any hd that is
// a multiple of 4 (the wrappers zero-pad the rest, with the real hd's
// softmax scale); the hd <= 256 instances never run them.
//
// Replaces, above hd 256: src/repro/kernels/decode_attention.py::
// decode_attention_pallas (line 66) and src/repro/kernels/prefill_attention.py::
// prefill_attention_pallas (line 90), which are shaped by hd alone.
//
// What bounds them on an H100. Decode reads each valid key and value once
// (about 0.5 FLOP a byte at one query head a KV head): device-memory
// bandwidth, so what counts is how many bytes are in flight on every SM and
// how little else sits between one tile's arrival and the next one's
// request. Prefill does 4 * hd FLOPs a (query, key) pair and reads each row
// once: the fp32 CUDA cores, so what counts is that the rows of one q tile
// share every K/V load, and how many FMAs a shared-memory load feeds.
//
// What both share, here. Rows (cache entries, keys, query rows) move from
// device memory into shared memory as tiles of up to 16 rows by one column
// slice of kSlice float4 (512 floats), through a ring of kStages slots.
// One warp asks the copy engine for a tile, a bulk copy (cp.async.bulk) a
// row, and the tile's mbarrier completes when its bytes have landed: no
// other thread spends an instruction on a load, and while one tile is in
// use the next kStages - 1 (or - 2) are in flight. A row's columns are
// walked slice by slice, so any hd fits: at hd <= 512 a row is one slice
// and a tile holds whole rows (hd 264 is not padded to 512: a tile holds
// its 66 float4 a row and no more). Above 512 each kernel makes one pass a
// slice of output columns (the accumulator of one slice lives in
// registers), scoring every pass over all slices. A row past the cache
// length or the sequence is not copied: its slot row keeps stale bytes,
// which a kernel masks out of the scores and never reads as a value. Every
// tile boundary, every sum's order and every pass depends only on the
// row's own length, hd and the group size, never on the batch: an output
// row is the same bytes at any B.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace wide {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlice = 128;                  // float4 columns of a tile row
constexpr int kPitch = 4 * kSlice + 4;       // floats between tile rows (16 B skew a row)
constexpr int kStages = 4;                   // ring slots

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 fma4(float p, float4 v, float4 a) {
  return make_float4(fmaf(p, v.x, a.x), fmaf(p, v.y, a.y), fmaf(p, v.z, a.z),
                     fmaf(p, v.w, a.w));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The ring's slots complete on mbarriers: one arrival a phase (the lane that
// asks for the tile, announcing its bytes) and the copies' bytes.
__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void bar_wait(unsigned long long* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// Warp-wide: ask the copy engine (cp.async.bulk) for a tile, lane r for row
// r < valid: ncols float4 from src + r * stride (floats) to dst + r *
// kPitch, completing on bar. Rows at r >= valid are not read and their
// slot rows keep whatever they held: a kernel never reads them as values.
__device__ __forceinline__ void fetch_tile(float* dst, const float* src, size_t stride,
                                           int valid, int ncols, unsigned long long* bar) {
  const int lane = threadIdx.x % 32;
  if (lane == 0)
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(valid * ncols * 16) : "memory");
  __syncwarp();
  if (lane < valid)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n"
        :: "r"(smem_u32(dst + lane * kPitch)), "l"(src + lane * stride), "r"(ncols * 16),
           "r"(smem_u32(bar))
        : "memory");
}

// Where a walk over a kernel's tile sequence stands: pass, block, and the
// tile within the block.
struct Cursor {
  int pass = 0, blk = 0, k = 0;
  __device__ __forceinline__ void next(int tiles_a_block, int blocks) {
    if (++k == tiles_a_block) {
      k = 0;
      if (++blk == blocks) {
        blk = 0;
        ++pass;
      }
    }
  }
};

}  // namespace wide
