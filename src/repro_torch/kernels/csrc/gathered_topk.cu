// ADR probe: query b scores only the rows named in cand[b] ((B, C) int32,
// id-sorted, -1 pads), then keeps the top-k of its row in the order of the
// TPU kernels' merge: score descending, then candidate column ascending. One
// templated kernel covers four TPU kernels, which differ only in where a row
// comes from and in its element type:
//
//   row source \ element     fp32                       int8 codes + fp32 scale
//   resident KB, by id       B4 fused_gathered_topk     B7 quant_fused_gathered_topk
//   slab (B, C, d), b*C+c    B5 gathered_topk           B8 quant_gathered_topk
//
// Replaces: src/repro/kernels/dense_topk.py::fused_gathered_topk_pallas
// (line 460), gathered_topk_pallas (line 145), quant_fused_gathered_topk_pallas
// (line 578) and quant_gathered_topk_pallas (line 340); merge _select_topk.
//
// Bound on an H100: bytes. Each real candidate row is read once (d*4 bytes,
// or d + 4 for int8) for 2*d FLOPs; at the fleet's merged call (B ~ 12,
// C = 62,500 over 4 probed buckets of a 500k x 768 KB) that is ~1.1 GB
// fp32, ~0.34 ms at 3.35 TB/s, and a quarter of it for int8.
//
// Design. The TPU kernels walk C in order on one core, DMA-ing each
// (B, block_c, d) tile into VMEM and carrying a running top-k. One CTA per
// query would leave most of the 132 SMs idle at the fleet's B ~ 12, so C is
// split across CTAs, as B1 splits N:
//  1. gathered_partial_kernel: grid (splits of 512 columns, B). A warp scores
//     one row at a time (four rows in flight): its lanes read the row with
//     coalesced 16-byte loads against q in shared memory, and a butterfly of
//     shuffles sums the lanes. Pad columns (cand < 0) are not read (the TPU
//     kernel fetches row 0 for them and masks the score), nor is an id past
//     the KB's N rows, which scores as a pad does. The split's 512
//     keys are sorted in shared memory and the best k written.
//  2. the leveled merge of topk_common.cuh, whose last level maps each key's
//     column back to its id and writes pads as (NEG, -1).
// The key's position is the column, not the id, so duplicate ids tie-break
// by column as in the TPU kernels. Each score is reduced in an order fixed
// by d alone (lane j sums elements 4j.. or 16j.. of every 128 / 512, then the
// butterfly), never by B, the split or the warp, so a query's row of results
// is the same at B = 1 (RaLMSeq) and in the fleet's merged call. int8 codes
// are cast to fp32 and the score is (q . float(code)) * scale, the multiply
// on the score: fp32 FMAs, not dp4a, because q is fp32.
#include "topk_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSplitCols = 512;    // candidate columns per CTA
constexpr int kRowsInFlight = 4;   // rows a warp loads before it sums them

// One lane's share of q . row: 16-byte loads j = lane, lane + 32, ... of
// kRowsInFlight rows at once (a null row, a pad column, is skipped).
__device__ __forceinline__ void lane_dots(const float* qs, const float* const* rows,
                                          int d, int lane, float* acc) {
  const int nvec = d / 4;
  for (int j = lane; j < nvec; j += 32) {
    const float4 w = *reinterpret_cast<const float4*>(qs + 4 * j);
    float4 x[kRowsInFlight];
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u)
      if (rows[u] != nullptr) x[u] = __ldg(reinterpret_cast<const float4*>(rows[u]) + j);
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      if (rows[u] == nullptr) continue;
      acc[u] = fmaf(w.x, x[u].x, acc[u]);
      acc[u] = fmaf(w.y, x[u].y, acc[u]);
      acc[u] = fmaf(w.z, x[u].z, acc[u]);
      acc[u] = fmaf(w.w, x[u].w, acc[u]);
    }
  }
}

__device__ __forceinline__ void lane_dots(const float* qs, const int8_t* const* rows,
                                          int d, int lane, float* acc) {
  const int nvec = d / 16;
  for (int j = lane; j < nvec; j += 32) {
    const float* qj = qs + 16 * j;
    uint4 x[kRowsInFlight];
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u)
      if (rows[u] != nullptr) x[u] = __ldg(reinterpret_cast<const uint4*>(rows[u]) + j);
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      if (rows[u] == nullptr) continue;
      const uint32_t w[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[u] = fmaf(qj[4 * i + e],
                        static_cast<float>(static_cast<int8_t>((w[i] >> (8 * e)) & 0xffu)),
                        acc[u]);
    }
  }
}

// kSlab: rows (B*C, d) and per-column scales (B*C,), else rows (N, d) and
// per-id scales (N,). scales == nullptr for fp32 rows.
template <typename T, bool kSlab>
__global__ void __launch_bounds__(kThreads)
gathered_partial_kernel(const float* __restrict__ q, const T* __restrict__ rows,
                        const float* __restrict__ scales, const int* __restrict__ cand,
                        uint64_t* __restrict__ partial, int N, int C, int d, int k) {
  extern __shared__ __align__(16) float qs[];     // [d]
  __shared__ uint64_t keys[kSplitCols];
  const int split = blockIdx.x, b = blockIdx.y;
  const int col0 = split * kSplitCols;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < d; i += kThreads) qs[i] = q[static_cast<size_t>(b) * d + i];
  __syncthreads();

  for (int r0 = warp * kRowsInFlight; r0 < kSplitCols; r0 += kWarps * kRowsInFlight) {
    const T* src[kRowsInFlight];
    size_t at[kRowsInFlight];                     // row index into rows / scales
    bool real[kRowsInFlight];
    float acc[kRowsInFlight];
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const int col = col0 + r0 + u;
      const int id = col < C ? cand[static_cast<size_t>(b) * C + col] : -1;
      real[u] = id >= 0 && (kSlab || id < N);
      at[u] = kSlab ? static_cast<size_t>(b) * C + col : static_cast<size_t>(id);
      src[u] = real[u] ? rows + at[u] * d : nullptr;
      acc[u] = 0.0f;
    }
    lane_dots(qs, src, d, lane, acc);
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], o);
    }
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        const int col = col0 + r0 + u;
        // past C: the empty key; a pad column: the sentinel score
        keys[r0 + u] = col >= C ? 0ull
                       : !real[u] ? make_key(kNeg, col)
                       : make_key(scales != nullptr ? acc[u] * scales[at[u]] : acc[u], col);
      }
    }
  }
  __syncthreads();
  bitonic_desc<kSplitCols>(keys, 1);
  for (int i = threadIdx.x; i < k; i += kThreads)
    partial[(static_cast<size_t>(b) * gridDim.x + split) * k + i] = keys[i];
}

template <typename T, bool kSlab>
int gathered(const float* q, const T* rows, const float* scales, const int* cand,
             uint64_t* partial, float* scores, int* ids, int B, int N, int C, int d,
             int k, cudaStream_t stream) {
  const int n = (C + kSplitCols - 1) / kSplitCols;
  gathered_partial_kernel<T, kSlab><<<dim3(n, B), kThreads, sizeof(float) * d, stream>>>(
      q, rows, scales, cand, partial, N, C, d, k);
  launch_merge(partial, scores, ids, B, n, k, cand, C, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gathered_topk_split_cols() { return kSplitCols; }

// Common to the four entry points: q (B, d) f32; cand (B, C) i32 with ids in
// [0, N), < 0 for a pad; partial u64 scratch of B * k * (n + ceil(n / 8))
// keys with n = ceil(C / 512) -> scores (B, k) f32, ids (B, k) i32. The
// caller guarantees 1 <= k <= 256 and d % 4 == 0 (fp32) or d % 16 == 0
// (int8), d <= 8192; k > C pads with (NEG, -1). The entry points that read
// the resident KB take its row count N and read no row at or past it: such
// a column scores NEG, like a pad, and keeps its id.

// B4: rows gathered by id from the resident KB (N, d) f32.
extern "C" int fused_gathered_topk_launch(const float* q, const float* kb, const int* cand,
                                          uint64_t* partial, float* scores, int* ids,
                                          int B, int N, int C, int d, int k,
                                          cudaStream_t stream) {
  return gathered<float, false>(q, kb, nullptr, cand, partial, scores, ids, B, N, C, d, k,
                                stream);
}

// B5: rows from a pre-gathered slab emb (B, C, d) f32.
extern "C" int gathered_topk_launch(const float* q, const float* emb, const int* cand,
                                    uint64_t* partial, float* scores, int* ids, int B,
                                    int C, int d, int k, cudaStream_t stream) {
  return gathered<float, true>(q, emb, nullptr, cand, partial, scores, ids, B, 0, C, d, k,
                               stream);
}

// B7: int8 codes (N, d) and scales (N,) gathered by id.
extern "C" int quant_fused_gathered_topk_launch(const float* q, const int8_t* codes,
                                                const float* scales, const int* cand,
                                                uint64_t* partial, float* scores, int* ids,
                                                int B, int N, int C, int d, int k,
                                                cudaStream_t stream) {
  return gathered<int8_t, false>(q, codes, scales, cand, partial, scores, ids, B, N, C, d,
                                 k, stream);
}

// B8: a pre-gathered code slab emb (B, C, d) i8 and scale slab scl (B, C) f32.
extern "C" int quant_gathered_topk_launch(const float* q, const int8_t* emb,
                                          const float* scl, const int* cand,
                                          uint64_t* partial, float* scores, int* ids, int B,
                                          int C, int d, int k, cudaStream_t stream) {
  return gathered<int8_t, true>(q, emb, scl, cand, partial, scores, ids, B, 0, C, d, k,
                                stream);
}
