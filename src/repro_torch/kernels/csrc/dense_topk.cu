// EDR full scan: scores = q . kb^T in fp32, then the top-k per query in the
// canonical order (score descending, then id ascending). The same scan over
// an int8 KB (codes plus a per-row fp32 scale) is B6.
//
// Replaces: src/repro/kernels/dense_topk.py::dense_topk_pallas (line 188;
// body _topk_kernel, merge _select_topk) and, templated on int8 rows,
// dense_topk.py::quant_topk_pallas (line 295; body _quant_topk_kernel).
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
//
// int8 rows (B6): 16 codes per 16-byte load, cast to fp32 in registers as
// they are staged, so the scoring loop is B1's; the row's scale multiplies
// the finished score before its key is formed, the TPU kernel's order
// (q . (s*c) == s * (q . c) in the reals). The scan reads N*d bytes, a
// quarter of B1's, so at the fleet's B ~ 12 the 2*B*N*d fp32 FLOPs bound it
// (9.2 GFLOP, 0.14 ms at 67 TFLOP/s) and at B = 1 the 384 MB read (0.11 ms).
#include "topk_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSplitRows = 1024;   // KB rows per CTA (512 for 16-query blocks)
constexpr int kTileRows = 256;     // rows scored per pass over d (one per thread)
constexpr int kChunkD = 32;        // columns of d staged per step
constexpr int kRowStride = kChunkD + 4;  // staged row pitch: float4 reads without bank conflicts

// One 16-byte load of KB row elements -> fp32 in shared memory: 4 floats
// as they are, or 16 int8 codes cast in registers.
__device__ __forceinline__ void stage(float* dst, uint4 v, float) {
  *reinterpret_cast<uint4*>(dst) = v;
}

__device__ __forceinline__ void stage(float* dst, uint4 v, int8_t) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(dst + 4 * i) = make_float4(
        static_cast<float>(static_cast<int8_t>(w[i] & 0xffu)),
        static_cast<float>(static_cast<int8_t>((w[i] >> 8) & 0xffu)),
        static_cast<float>(static_cast<int8_t>((w[i] >> 16) & 0xffu)),
        static_cast<float>(static_cast<int8_t>(w[i] >> 24)));
}

template <int QB, int SR, typename T>
__global__ void __launch_bounds__(kThreads)
topk_partial_kernel(const float* __restrict__ q, const T* __restrict__ kb,
                    const float* __restrict__ scales, uint64_t* __restrict__ partial,
                    int B, int N, int d, int k) {
  constexpr int kVec = 16 / sizeof(T);                            // elements per 16-byte load
  constexpr int kLoads = kTileRows * (kChunkD / kVec) / kThreads; // loads per thread per step
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
  uint4 pre[kLoads];
  auto load = [&](int step) {
    const int tile0 = row0 + (step / nchunk) * kTileRows;
    const int c0 = (step % nchunk) * kChunkD;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int f = tid + u * kThreads;
      const int grow = tile0 + f / (kChunkD / kVec), gcol = c0 + (f % (kChunkD / kVec)) * kVec;
      pre[u] = make_uint4(0u, 0u, 0u, 0u);
      if (grow < N && gcol < d)
        pre[u] = *reinterpret_cast<const uint4*>(kb + static_cast<size_t>(grow) * d + gcol);
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
      stage(kbt + (f / (kChunkD / kVec)) * kRowStride + (f % (kChunkD / kVec)) * kVec,
            pre[u], T());
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
      // int8 rows: the row's scale multiplies the finished score
      const float scale = (scales != nullptr && grow < N) ? scales[grow] : 1.0f;
#pragma unroll
      for (int j = 0; j < QB; ++j) {
        const float s = scales != nullptr ? acc[j] * scale : acc[j];
        keys[j * SR + t * kTileRows + tid] =
            grow < N ? make_key(s, grow) : make_key(kNeg, -1);
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

template <int QB, int SR, typename T>
void launch_partial(const float* q, const T* kb, const float* scales, uint64_t* partial,
                    int B, int N, int d, int k, cudaStream_t stream) {
  const size_t smem = sizeof(uint64_t) * QB * SR +
                      sizeof(float) * (kTileRows * kRowStride + kChunkD * QB);
  cudaFuncSetAttribute(topk_partial_kernel<QB, SR, T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  dim3 grid((B + QB - 1) / QB, (N + SR - 1) / SR);
  topk_partial_kernel<QB, SR, T><<<grid, kThreads, smem, stream>>>(q, kb, scales, partial,
                                                                    B, N, d, k);
}

// KB rows per split for a batch of B queries (query blocks of 16 take half
// the rows, to keep their sort keys within shared memory)
int split_rows(int B) { return B > 8 ? kSplitRows / 2 : kSplitRows; }

template <typename T>
int scan(const float* q, const T* kb, const float* scales, uint64_t* partial,
         float* scores, int* ids, int B, int N, int d, int k, cudaStream_t stream) {
  if (B == 1)
    launch_partial<1, kSplitRows>(q, kb, scales, partial, B, N, d, k, stream);
  else if (B <= 4)
    launch_partial<4, kSplitRows>(q, kb, scales, partial, B, N, d, k, stream);
  else if (B <= 8)
    launch_partial<8, kSplitRows>(q, kb, scales, partial, B, N, d, k, stream);
  else
    launch_partial<16, kSplitRows / 2>(q, kb, scales, partial, B, N, d, k, stream);
  launch_merge(partial, scores, ids, B, (N + split_rows(B) - 1) / split_rows(B), k,
               nullptr, 0, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dense_topk_split_rows(int B) { return split_rows(B); }

// q (B, d) f32, kb (N, d) f32, partial u64 scratch of B * k * (n + ceil(n / 8))
// keys with n = ceil(N / split_rows(B)) -> scores (B, k) f32, ids (B, k) i32. The caller guarantees
// 1 <= k <= min(N, 256) and d % 4 == 0.
extern "C" int dense_topk_launch(const float* q, const float* kb, uint64_t* partial,
                                 float* scores, int* ids, int B, int N, int d, int k,
                                 cudaStream_t stream) {
  return scan<float>(q, kb, nullptr, partial, scores, ids, B, N, d, k, stream);
}

// B6: the same scan over int8 codes (N, d) with fp32 row scales (N,): the
// score is (q . float(code)) * scale. The caller guarantees d % 16 == 0.
extern "C" int quant_topk_launch(const float* q, const int8_t* codes, const float* scales,
                                 uint64_t* partial, float* scores, int* ids, int B, int N,
                                 int d, int k, cudaStream_t stream) {
  return scan<int8_t>(q, codes, scales, partial, scores, ids, B, N, d, k, stream);
}
