// EDR full scan: scores = q . kb^T in fp32, then the top-k per query in the
// canonical order (score descending, then id ascending).
//
// Replaces: src/repro/kernels/dense_topk.py::dense_topk_pallas (line 188;
// body _topk_kernel, merge _select_topk).
//
// Bound on an H100: at the small batches of the serving path (B = 1 for
// RaLMSeq, B ~ slots x stride for the fleet) the scan reads the whole KB once,
// N*d*4 bytes (1.5 GB at N = 500k, d = 768), against a few FLOPs per byte, so
// device-memory bandwidth bounds it. At B >= ~40 the 2*B*N*d fp32 FLOPs on the
// CUDA cores take over (no TF32: parity with the exact backends needs IEEE
// fp32).
//
// Design. The TPU kernel walks KB tiles in order on one core and carries a
// running top-k in VMEM from one grid step to the next. CTAs on 132 SMs run in
// no order, so the scan is two passes:
//  1. topk_partial_kernel: grid (query blocks of QB <= 16, KB splits of 1024
//     rows, 512 for QB = 16). Each CTA streams its rows through shared memory
//     with coalesced 16-byte loads, the next chunk already in flight into
//     registers while the current one is scored (one row per thread, QB
//     accumulators, 16-byte shared-memory reads of the row and of four
//     queries at a time). It keeps the split's scores as 64-bit sort keys in
//     shared memory, sorts each query's keys with a bitonic network and writes
//     the best k as that split's partial list. The serving path's merged
//     fleet call (B ~ 12) fits one query block, so the KB is read once.
//     Consecutive CTAs share a split, so a split's rows are read from device
//     memory once and from L2 for the other query blocks.
//  2. topk_merge_kernel, in levels: a CTA sorts the partial lists of up to
//     2048 / k splits of one query and keeps the best k, until one list per
//     query is left (two levels at k = 20 over 500k rows).
// A key is (order-preserving bits of the score) << 32 | ~id, so one unsigned
// comparison gives score descending, then id ascending; pads (rows >= N) carry
// the kernel sentinel (NEG = -3.4e38, id -1), whose key sorts after any real
// row. Every score is one thread's fmaf chain over d = 0..d-1 in order, so it
// does not depend on B, on the query block or on the split: a query's row of
// results is the same whatever batch it arrives in.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSplitRows = 1024;   // KB rows per CTA (512 for 16-query blocks)
constexpr int kTileRows = 256;     // rows scored per pass over d (one per thread)
constexpr int kChunkD = 32;        // columns of d staged per step
constexpr int kRowStride = kChunkD + 4;  // staged row pitch: float4 reads without bank conflicts
constexpr int kMergeThreads = 1024;
constexpr int kMergeBuf = 2048;    // keys sorted at once in the merge
constexpr float kNeg = -3.4e38f;

__device__ __forceinline__ uint32_t ord_of(float f) {
  uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float float_of(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__device__ __forceinline__ uint64_t make_key(float s, int id) {
  if (s == 0.0f) s = 0.0f;         // -0 and +0 tie, as they do on the host
  return (static_cast<uint64_t>(ord_of(s)) << 32) |
         static_cast<uint32_t>(~static_cast<uint32_t>(id));
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

template <int QB, int SR>
__global__ void __launch_bounds__(kThreads)
topk_partial_kernel(const float* __restrict__ q, const float* __restrict__ kb,
                    uint64_t* __restrict__ partial, int B, int N, int d, int k) {
  constexpr int kLoads = kTileRows * (kChunkD / 4) / kThreads;   // float4 per thread
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* keys = reinterpret_cast<uint64_t*>(smem);             // [QB][SR]
  float* kbt = reinterpret_cast<float*>(keys + QB * SR);          // [kTileRows][kRowStride]
  float* qs = kbt + kTileRows * kRowStride;                       // [kChunkD][QB]

  const int q0 = blockIdx.x * QB;
  const int split = blockIdx.y;
  const int row0 = split * SR;
  const int tid = threadIdx.x;
  const int nchunk = (d + kChunkD - 1) / kChunkD;
  const int steps = (SR / kTileRows) * nchunk;

  // the next chunk of KB rows is loaded into registers while the current one
  // is scored from shared memory, so device-memory latency overlaps the FMAs
  float4 pre[kLoads];
  auto load = [&](int step) {
    const int tile0 = row0 + (step / nchunk) * kTileRows;
    const int c0 = (step % nchunk) * kChunkD;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int f = tid + u * kThreads;
      const int grow = tile0 + f / (kChunkD / 4), gcol = c0 + (f % (kChunkD / 4)) * 4;
      pre[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (grow < N && gcol < d)
        pre[u] = *reinterpret_cast<const float4*>(kb + static_cast<size_t>(grow) * d + gcol);
    }
  };

  float acc[QB];
#pragma unroll
  for (int j = 0; j < QB; ++j) acc[j] = 0.0f;
  load(0);
  for (int step = 0; step < steps; ++step) {
    const int t = step / nchunk, c0 = (step % nchunk) * kChunkD;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int f = tid + u * kThreads;
      *reinterpret_cast<float4*>(kbt + (f / (kChunkD / 4)) * kRowStride +
                                 (f % (kChunkD / 4)) * 4) = pre[u];
    }
    for (int f = tid; f < QB * kChunkD; f += kThreads) {
      const int j = f / kChunkD, c = f % kChunkD;
      const int gq = q0 + j, gcol = c0 + c;
      qs[c * QB + j] = (gq < B && gcol < d) ? q[static_cast<size_t>(gq) * d + gcol] : 0.0f;
    }
    __syncthreads();
    if (step + 1 < steps) load(step + 1);
    const int cmax = min(kChunkD, d - c0);       // a multiple of 4
    const float* row = kbt + tid * kRowStride;
    for (int c4 = 0; c4 < cmax; c4 += 4) {
      const float4 x4 = *reinterpret_cast<const float4*>(row + c4);
      const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* qc = qs + (c4 + e) * QB;
        if constexpr (QB % 4 == 0) {
#pragma unroll
          for (int j = 0; j < QB; j += 4) {
            const float4 w = *reinterpret_cast<const float4*>(qc + j);
            acc[j] = fmaf(w.x, xs[e], acc[j]);
            acc[j + 1] = fmaf(w.y, xs[e], acc[j + 1]);
            acc[j + 2] = fmaf(w.z, xs[e], acc[j + 2]);
            acc[j + 3] = fmaf(w.w, xs[e], acc[j + 3]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < QB; ++j) acc[j] = fmaf(qc[j], xs[e], acc[j]);
        }
      }
    }
    if (step % nchunk == nchunk - 1) {           // this tile's rows are scored
      const int grow = row0 + t * kTileRows + tid;
#pragma unroll
      for (int j = 0; j < QB; ++j) {
        keys[j * SR + t * kTileRows + tid] =
            grow < N ? make_key(acc[j], grow) : make_key(kNeg, -1);
        acc[j] = 0.0f;
      }
    }
    __syncthreads();
  }
  bitonic_desc<SR>(keys, QB);
  for (int f = tid; f < QB * k; f += kThreads) {
    const int j = f / k, i = f - j * k;
    const int gq = q0 + j;
    if (gq < B)
      partial[(static_cast<size_t>(gq) * gridDim.y + split) * k + i] = keys[j * SR + i];
  }
}

// One level of the merge: each CTA sorts the lists [g*G, g*G + G) of one
// query (G * k <= kMergeBuf keys) and keeps the best k, so every level cuts
// the lists per query by G. The last level (one list left) writes scores and
// ids instead of keys.
__global__ void __launch_bounds__(kMergeThreads)
topk_merge_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                  float* __restrict__ scores, int* __restrict__ ids, int n_in, int k,
                  int G) {
  __shared__ uint64_t buf[kMergeBuf];
  const int g = blockIdx.x, b = blockIdx.y, n_out = gridDim.x;
  const int total = min(G, n_in - g * G) * k;
  const uint64_t* src = in + (static_cast<size_t>(b) * n_in + g * G) * k;
  for (int x = threadIdx.x; x < kMergeBuf; x += blockDim.x)
    buf[x] = x < total ? src[x] : 0ull;        // empty slot: the smallest key
  __syncthreads();
  bitonic_desc<kMergeBuf>(buf, 1);
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const uint64_t key = buf[i];
    if (n_out > 1) {
      out[(static_cast<size_t>(b) * n_out + g) * k + i] = key;
    } else {
      scores[static_cast<size_t>(b) * k + i] = float_of(static_cast<uint32_t>(key >> 32));
      ids[static_cast<size_t>(b) * k + i] = static_cast<int>(~static_cast<uint32_t>(key));
    }
  }
}

template <int QB, int SR>
void launch_partial(const float* q, const float* kb, uint64_t* partial, int B,
                    int N, int d, int k, cudaStream_t stream) {
  const size_t smem = sizeof(uint64_t) * QB * SR +
                      sizeof(float) * (kTileRows * kRowStride + kChunkD * QB);
  cudaFuncSetAttribute(topk_partial_kernel<QB, SR>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  dim3 grid((B + QB - 1) / QB, (N + SR - 1) / SR);
  topk_partial_kernel<QB, SR><<<grid, kThreads, smem, stream>>>(q, kb, partial, B, N, d, k);
}

// KB rows per split for a batch of B queries (query blocks of 16 take half
// the rows, to keep their sort keys within shared memory)
int split_rows(int B) { return B > 8 ? kSplitRows / 2 : kSplitRows; }

}  // namespace

extern "C" int dense_topk_split_rows(int B) { return split_rows(B); }

// q (B, d) f32, kb (N, d) f32, partial u64 scratch of B * k * (n + ceil(n / 8))
// keys with n = ceil(N / split_rows(B)) -> scores (B, k) f32, ids (B, k) i32. The caller guarantees
// 1 <= k <= min(N, 256) and d % 4 == 0.
extern "C" int dense_topk_launch(const float* q, const float* kb, uint64_t* partial,
                                 float* scores, int* ids, int B, int N, int d, int k,
                                 cudaStream_t stream) {
  if (B == 1)
    launch_partial<1, kSplitRows>(q, kb, partial, B, N, d, k, stream);
  else if (B <= 4)
    launch_partial<4, kSplitRows>(q, kb, partial, B, N, d, k, stream);
  else if (B <= 8)
    launch_partial<8, kSplitRows>(q, kb, partial, B, N, d, k, stream);
  else
    launch_partial<16, kSplitRows / 2>(q, kb, partial, B, N, d, k, stream);
  // merge levels, ping-ponging between the split lists and a second region of
  // ceil(n_splits / 8) lists (G >= 8 since k <= 256; the lists only shrink)
  int n = (N + split_rows(B) - 1) / split_rows(B);
  const int G = kMergeBuf / k;
  uint64_t* bufs[2] = {partial, partial + static_cast<size_t>(B) * k * n};
  int cur = 0;
  do {
    const int n_out = (n + G - 1) / G;
    topk_merge_kernel<<<dim3(n_out, B), kMergeThreads, 0, stream>>>(
        bufs[cur], bufs[cur ^ 1], scores, ids, n, k, G);
    n = n_out;
    cur ^= 1;
  } while (n > 1);
  return static_cast<int>(cudaGetLastError());
}
