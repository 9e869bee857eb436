// The top-k machinery shared by the scans (dense_topk.cu: B1, B6;
// gathered_topk.cu: B4, B5, B7, B8): the sort key, the merge of the scan's
// partial lists (k <= 256), and the select pass over every key of a row
// (k > 256).
//
// A key is (order-preserving bits of the score) << 32 | ~pos, so one unsigned
// comparison gives score descending, then pos ascending. pos is the KB row id
// for the full scans and the candidate column for the gathered scans: the
// TPU kernels' merge (_select_topk) breaks ties by position, which is id
// order because the backends hand in id-sorted candidate rows. The empty key
// 0 sorts after every real key; pads carry the kernel sentinel kNeg.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_attr.cuh"

namespace {

constexpr int kMergeThreads = 1024;
constexpr int kMergeBuf = 4096;         // keys a merge CTA sorts at most
constexpr int kSelectThreads = 1024;
constexpr int kSelectSmemKeys = 16384;  // a top k of up to this many keys sorts in shared memory
constexpr float kNeg = -3.4e38f;

__device__ __forceinline__ uint32_t ord_of(float f) {
  uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float float_of(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__device__ __forceinline__ uint64_t make_key(float s, int pos) {
  if (s == 0.0f) s = 0.0f;         // -0 and +0 tie, as they do on the host
  return (static_cast<uint64_t>(ord_of(s)) << 32) |
         static_cast<uint32_t>(~static_cast<uint32_t>(pos));
}

// Sort n keys (n a power of two) descending, in place, with the whole CTA.
// keys may lie in shared or in global memory (the CTA's own rows only).
// Strides are powers of two, so pair indices come from bit operations.
__device__ void bitonic_desc(uint64_t* keys, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < n / 2; i += blockDim.x) {
        const int a = i + (i & -stride);       // 2*stride*(i/stride) + i%stride
        const bool desc = (a & size) == 0;
        const uint64_t x = keys[a], y = keys[a + stride];
        if ((x < y) == desc) { keys[a] = y; keys[a + stride] = x; }
      }
      __syncthreads();
    }
  }
}

// Slot o of the results of query b from one key. With cand == nullptr a
// key's pos is the id; else pos is a column of cand (B, C), and a pad column
// (cand < 0) or a column past C comes out as (kNeg, -1). The empty key comes
// out as (kNeg, -1) either way.
__device__ __forceinline__ void write_result(uint64_t key, size_t o, int b, const int* cand,
                                             int C, float* scores, int* ids) {
  const uint32_t pos = ~static_cast<uint32_t>(key);
  int id;
  if (cand == nullptr)
    id = key == 0ull ? -1 : static_cast<int>(pos);
  else
    id = key != 0ull && pos < static_cast<uint32_t>(C) ? cand[static_cast<size_t>(b) * C + pos]
                                                       : -1;
  scores[o] = id < 0 ? kNeg : float_of(static_cast<uint32_t>(key >> 32));
  ids[o] = id < 0 ? -1 : id;
}

// One level of the merge: each CTA takes the lists [g*G, g*G + G) of one
// query (G * k <= kMergeBuf keys) and keeps the best k, so every level cuts
// the lists per query by G. Every list holds k keys (an empty slot is the key
// 0), all at or above the list's smallest, so the largest of the lists'
// smallest keys is at or below the k-th best: only the keys at or above it
// (at least k) are sorted, as the next power of two. The last level (one list
// left) writes scores and ids instead of keys.
__global__ void __launch_bounds__(kMergeThreads)
topk_merge_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                  float* __restrict__ scores, int* __restrict__ ids, int n_in, int k,
                  int G, const int* __restrict__ cand, int C) {
  constexpr int kPerThread = kMergeBuf / kMergeThreads;
  __shared__ uint64_t buf[kMergeBuf];
  __shared__ uint64_t s_bound;
  __shared__ int s_count;
  const int g = blockIdx.x, b = blockIdx.y, n_out = gridDim.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n_lists = min(G, n_in - g * G), total = n_lists * k;
  const uint64_t* src = in + (static_cast<size_t>(b) * n_in + g * G) * k;
  uint64_t mine[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int x = tid + j * kMergeThreads;
    mine[j] = x < total ? src[x] : 0ull;
    if (x < total) buf[x] = mine[j];
  }
  if (tid == 0) { s_bound = 0ull; s_count = 0; }
  __syncthreads();
  if (k >= 32) {                       // a warp per list
    for (int l = warp; l < n_lists; l += kMergeThreads / 32) {
      unsigned long long m = ~0ull;
      for (int i = lane; i < k; i += 32) m = min(m, static_cast<unsigned long long>(buf[l * k + i]));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = min(m, __shfl_xor_sync(0xffffffffu, m, o));
      if (lane == 0) atomicMax(reinterpret_cast<unsigned long long*>(&s_bound), m);
    }
  } else {                             // a thread per list
    for (int l = tid; l < n_lists; l += kMergeThreads) {
      unsigned long long m = ~0ull;
      for (int i = 0; i < k; ++i) m = min(m, static_cast<unsigned long long>(buf[l * k + i]));
      atomicMax(reinterpret_cast<unsigned long long*>(&s_bound), m);
    }
  }
  __syncthreads();
  const uint64_t bound = s_bound;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j)  // every key left in buf was read into mine
    if (tid + j * kMergeThreads < total && mine[j] >= bound)
      buf[atomicAdd(&s_count, 1)] = mine[j];
  __syncthreads();
  const int m = s_count;               // k <= m <= total
  int P = 2;
  while (P < m) P <<= 1;
  for (int x = m + tid; x < P; x += kMergeThreads) buf[x] = 0ull;
  __syncthreads();
  bitonic_desc(buf, P);
  for (int i = tid; i < k; i += kMergeThreads) {
    if (n_out > 1)
      out[(static_cast<size_t>(b) * n_out + g) * k + i] = buf[i];
    else
      write_result(buf[i], static_cast<size_t>(b) * k + i, b, cand, C, scores, ids);
  }
}

// The merge levels over n partial lists of k <= 256 keys per query,
// ping-ponging between the lists and a second region of ceil(n / 8) lists
// right after them (G >= 16; the lists only shrink). `partial` holds
// B * k * (n + ceil(n / 8)) keys. Keys are unique per query, so the result
// does not depend on how the lists are grouped.
void launch_merge(uint64_t* partial, float* scores, int* ids, int B, int n, int k,
                  const int* cand, int C, cudaStream_t stream) {
  const int G = kMergeBuf / k;
  uint64_t* bufs[2] = {partial, partial + static_cast<size_t>(B) * k * n};
  int cur = 0;
  do {
    const int n_out = (n + G - 1) / G;
    topk_merge_kernel<<<dim3(n_out, B), kMergeThreads, 0, stream>>>(
        bufs[cur], bufs[cur ^ 1], scores, ids, n, k, G, cand, C);
    n = n_out;
    cur ^= 1;
  } while (n > 1);
}

// The select pass for k > 256, one CTA per query over the query's n keys
// (every row's key, written by the scan's key pass; keys are unique):
//  1. a radix select, 8 bits a pass from the top, finds the digits of the
//     kk-th largest key (kk = min(k, n)), stopping once the bucket that
//     holds it is taken whole;
//  2. the keys at or above it, exactly kk, are compacted into `sorted`: in
//     shared memory when P (kk rounded up to a power of two) <= 16384, else
//     in the query's P-key row of `sortbuf`;
//  3. a bitonic sort of those P keys (empty slots 0) in place;
//  4. write_result maps each key to its score and id; slots past kk are
//     (kNeg, -1).
__global__ void __launch_bounds__(kSelectThreads)
topk_select_kernel(const uint64_t* __restrict__ keys, uint64_t* __restrict__ sortbuf,
                   float* __restrict__ scores, int* __restrict__ ids, int n, int k, int P,
                   const int* __restrict__ cand, int C) {
  extern __shared__ __align__(16) uint64_t smem_keys[];     // [P] when P <= kSelectSmemKeys
  __shared__ int hist[256];
  __shared__ uint64_t s_prefix;
  __shared__ int s_remaining, s_done, s_count;
  const int b = blockIdx.x, tid = threadIdx.x;
  const uint64_t* row = keys + static_cast<size_t>(b) * n;
  const int kk = min(k, n);
  uint64_t prefix = 0ull, mask = 0ull;
  int remaining = kk;
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += blockDim.x) hist[i] = 0;
    __syncthreads();
    for (int i = tid; i < n; i += blockDim.x) {
      const uint64_t key = row[i];
      if ((key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 0xffu], 1);
    }
    __syncthreads();
    if (tid == 0) {
      int above = 0, bin = 255;
      for (; bin > 0; --bin) {               // the digit of the remaining-th key
        if (above + hist[bin] >= remaining) break;
        above += hist[bin];
      }
      s_prefix = prefix | (static_cast<uint64_t>(bin) << shift);
      s_remaining = remaining - above;
      s_done = hist[bin] == remaining - above;   // its bucket is taken whole
    }
    __syncthreads();
    prefix = s_prefix;
    mask |= 0xffull << shift;
    remaining = s_remaining;
    if (s_done) break;                       // uniform across the CTA
  }
  // exactly kk keys satisfy (key & mask) >= prefix: the buckets above, each
  // taken whole, and the last one
  uint64_t* sorted = P <= kSelectSmemKeys ? smem_keys : sortbuf + static_cast<size_t>(b) * P;
  if (tid == 0) s_count = 0;
  __syncthreads();
  for (int i = tid; i < n; i += blockDim.x) {
    const uint64_t key = row[i];
    if ((key & mask) >= prefix) {
      const int at = atomicAdd(&s_count, 1);
      if (at < P) sorted[at] = key;    // kk of them: the keys are unique
    }
  }
  for (int i = kk + tid; i < P; i += blockDim.x) sorted[i] = 0ull;
  __syncthreads();
  bitonic_desc(sorted, P);
  for (int i = tid; i < k; i += blockDim.x)
    write_result(i < kk ? sorted[i] : 0ull, static_cast<size_t>(b) * k + i, b, cand, C,
                 scores, ids);
}

// keys (B, n) -> the top k of each row; sortbuf holds B * P keys when P >
// kSelectSmemKeys (else it is not touched).
void launch_select(const uint64_t* keys, uint64_t* sortbuf, float* scores, int* ids, int B,
                   int n, int k, const int* cand, int C, cudaStream_t stream) {
  // once per device
  static bool smem_allowed[kMaxDevices] = {};
  allow_smem(smem_allowed, topk_select_kernel,
             static_cast<int>(kSelectSmemKeys * sizeof(uint64_t)));
  const int kk = k < n ? k : n;
  int P = 1;
  while (P < kk) P <<= 1;
  const size_t smem = P <= kSelectSmemKeys ? P * sizeof(uint64_t) : 0;
  topk_select_kernel<<<B, kSelectThreads, smem, stream>>>(keys, sortbuf, scores, ids, n, k, P,
                                                          cand, C);
}

}  // namespace
