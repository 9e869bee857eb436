// The top-k machinery shared by the scans (dense_topk.cu: B1, B6;
// gathered_topk.cu: B4, B5, B7, B8).
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

namespace {

constexpr int kMergeThreads = 1024;
constexpr int kMergeBuf = 2048;    // keys sorted at once in the merge (default)
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

// Sort nseg segments of N keys each (N a power of two) descending, in place.
// Strides are powers of two, so pair indices come from bit operations.
template <int N>
__device__ void bitonic_desc(uint64_t* keys, int nseg) {
  constexpr int kHalf = N / 2;
  const int pairs = nseg * kHalf;
  for (int size = 2; size <= N; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < pairs; i += blockDim.x) {
        const int seg = i / kHalf, ii = i % kHalf;
        const int a = ii + (ii & -stride);     // 2*stride*(ii/stride) + ii%stride
        const bool desc = (a & size) == 0;
        uint64_t* base = keys + static_cast<size_t>(seg) * N;
        const uint64_t x = base[a], y = base[a + stride];
        if ((x < y) == desc) { base[a] = y; base[a + stride] = x; }
      }
      __syncthreads();
    }
  }
}

// One level of the merge: each CTA sorts the lists [g*G, g*G + G) of one
// query (G * k <= BUF keys) and keeps the best k, so every level cuts
// the lists per query by G. The last level (one list left) writes scores and
// ids instead of keys. With cand == nullptr a key's pos is the id; else pos
// is a column of cand (B, C), and a pad column (cand < 0), a column past C
// or an empty key comes out as (kNeg, -1).
template <int BUF>
__global__ void __launch_bounds__(kMergeThreads)
topk_merge_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                  float* __restrict__ scores, int* __restrict__ ids, int n_in, int k,
                  int G, const int* __restrict__ cand, int C) {
  __shared__ uint64_t buf[BUF];
  const int g = blockIdx.x, b = blockIdx.y, n_out = gridDim.x;
  const int total = min(G, n_in - g * G) * k;
  const uint64_t* src = in + (static_cast<size_t>(b) * n_in + g * G) * k;
  for (int x = threadIdx.x; x < BUF; x += blockDim.x)
    buf[x] = x < total ? src[x] : 0ull;        // empty slot: the smallest key
  __syncthreads();
  bitonic_desc<BUF>(buf, 1);
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const uint64_t key = buf[i];
    const size_t o = static_cast<size_t>(b) * k + i;
    if (n_out > 1) {
      out[(static_cast<size_t>(b) * n_out + g) * k + i] = key;
    } else if (cand == nullptr) {
      scores[o] = float_of(static_cast<uint32_t>(key >> 32));
      ids[o] = static_cast<int>(~static_cast<uint32_t>(key));
    } else {
      const uint32_t pos = ~static_cast<uint32_t>(key);
      const int id = pos < static_cast<uint32_t>(C)
                         ? cand[static_cast<size_t>(b) * C + pos] : -1;
      scores[o] = id < 0 ? kNeg : float_of(static_cast<uint32_t>(key >> 32));
      ids[o] = id < 0 ? -1 : id;
    }
  }
}

// The merge levels over n partial lists of k keys per query, ping-ponging
// between the lists and a second region of ceil(n / 8) lists right after
// them (G >= 8 since k <= 256 and BUF >= 2048; the lists only shrink).
// `partial` holds B * k * (n + ceil(n / 8)) keys. Keys are unique per query,
// so the result does not depend on BUF or on how the lists are grouped. A
// larger BUF takes fewer levels for many lists and costs a longer sort for
// few: the gathered scans (~123 lists of k keys) keep 2048, where 4096 took
// ~0.016 ms more per call at k = 1 and 256 on an H100 (PERF.md).
template <int BUF = kMergeBuf>
void launch_merge(uint64_t* partial, float* scores, int* ids, int B, int n, int k,
                  const int* cand, int C, cudaStream_t stream) {
  const int G = BUF / k;
  uint64_t* bufs[2] = {partial, partial + static_cast<size_t>(B) * k * n};
  int cur = 0;
  do {
    const int n_out = (n + G - 1) / G;
    topk_merge_kernel<BUF><<<dim3(n_out, B), kMergeThreads, 0, stream>>>(
        bufs[cur], bufs[cur ^ 1], scores, ids, n, k, G, cand, C);
    n = n_out;
    cur ^= 1;
  } while (n > 1);
}

}  // namespace
