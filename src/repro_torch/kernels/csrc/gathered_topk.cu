// ADR probe: query b scores only the rows named in cand[b] ((B, C) int32,
// id-sorted, -1 pads), then keeps the top-k of its row in the order of the
// TPU kernels' merge: score descending, then candidate column ascending. One
// templated scan covers four TPU kernels, which differ only in where a row
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
// or d + 4 for int8) for 2*d FLOPs; at RaLMSeq's B = 1 (C = 62,500 over 4
// probed buckets of a 500k x 768 KB, ~60% of them real) that is ~0.12 GB
// fp32, ~0.036 ms at 3.35 TB/s; at the fleet's merged B ~ 12, ~1.1 GB.
//
// Design: scan.cuh's scan with a row indirection (Src::kFused / kSlab), one
// query per CTA, two CTAs per SM (a 3-step fp32 or 5-step int8 cp.async ring
// each). The caller shares the 2 x 132 CTA slots among the queries (`lists`
// CTAs per query: 245 at B = 1, one 256-column tile each; 22 at B = 12).
// A CTA looks its tiles' row ids up once, skips a tile of pads only (the
// backends put the pads last: ~40% of the tiles at B = 1), reads no pad and
// no id past the KB's N rows (the column scores kNeg, as in the TPU kernels,
// and keeps its id), and selects by threshold: at k = 1 a row is dropped in
// registers unless it beats the CTA's best. The merge (topk_common.cuh)
// sorts only the keys at or above the largest of the lists' smallest keys,
// maps each key's column back to its id and writes pads as (NEG, -1). k >
// 256 takes the key pass and the select pass. The key's position is the
// column, not the id, so duplicate ids tie-break by column as in the TPU
// kernels. Each score is one thread's fmaf chain over d in order, as in the
// full scans (never by B, the split or k), so a query's row of results is
// the same at B = 1 (RaLMSeq) and in the fleet's merged call. int8 codes are
// cast to fp32 and the score is (q . float(code)) * scale, the multiply on
// the score.
#include "scan.cuh"

namespace {

// CTAs per SM (dense_topk.py: GATHER_CTAS_PER_SM): at B = 1 one 256-column
// tile per CTA, and the fixed cost of a ring step overlaps between two CTAs
constexpr int kGatherCtas = 2;

template <typename T, Src S>
int gathered(const float* q, const T* rows, const float* scales, const int* cand,
             uint64_t* partial, float* scores, int* ids, int B, int N, int C, int d, int k,
             int lists, cudaStream_t stream) {
  if (k > kMaxK) {                     // every column's key, then the select pass
    launch_scan<1, 1, 1, 256, T, S, true, kGatherCtas>(q, rows, scales, cand, partial, B, N, C,
                                                       d, k, lists, stream);
    launch_select(partial, partial + static_cast<size_t>(B) * C, scores, ids, B, C, k, cand, C,
                  stream);
  } else {
    launch_scan<1, 1, 1, 256, T, S, false, kGatherCtas>(q, rows, scales, cand, partial, B, N,
                                                        C, d, k, lists, stream);
    launch_merge(partial, scores, ids, B, lists, k, cand, C, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Common to the four entry points: q (B, d) f32; cand (B, C) i32 with ids in
// [0, N), < 0 for a pad; lists the scan's CTAs per query (1 <= lists <=
// ceil(C / 256)); partial u64 scratch as the full scans' with C columns
// (dense_topk.py's scan_scratch) -> scores (B, k) f32, ids (B, k) i32. The
// caller guarantees k >= 1 and d % 4 == 0 (fp32) or d % 16 == 0 (int8); k > C
// pads with (NEG, -1). The entry points that read the resident KB take its
// row count N and read no row at or past it: such a column scores NEG, like
// a pad, and keeps its id.

// B4: rows gathered by id from the resident KB (N, d) f32.
extern "C" int fused_gathered_topk_launch(const float* q, const float* kb, const int* cand,
                                          uint64_t* partial, float* scores, int* ids,
                                          int B, int N, int C, int d, int k, int lists,
                                          cudaStream_t stream) {
  return gathered<float, Src::kFused>(q, kb, nullptr, cand, partial, scores, ids, B, N, C, d,
                                      k, lists, stream);
}

// B5: rows from a pre-gathered slab emb (B, C, d) f32.
extern "C" int gathered_topk_launch(const float* q, const float* emb, const int* cand,
                                    uint64_t* partial, float* scores, int* ids, int B,
                                    int C, int d, int k, int lists, cudaStream_t stream) {
  return gathered<float, Src::kSlab>(q, emb, nullptr, cand, partial, scores, ids, B, 0, C, d,
                                     k, lists, stream);
}

// B7: int8 codes (N, d) and scales (N,) gathered by id.
extern "C" int quant_fused_gathered_topk_launch(const float* q, const int8_t* codes,
                                                const float* scales, const int* cand,
                                                uint64_t* partial, float* scores, int* ids,
                                                int B, int N, int C, int d, int k, int lists,
                                                cudaStream_t stream) {
  return gathered<int8_t, Src::kFused>(q, codes, scales, cand, partial, scores, ids, B, N, C,
                                       d, k, lists, stream);
}

// B8: a pre-gathered code slab emb (B, C, d) i8 and scale slab scl (B, C) f32.
extern "C" int quant_gathered_topk_launch(const float* q, const int8_t* emb,
                                          const float* scl, const int* cand,
                                          uint64_t* partial, float* scores, int* ids, int B,
                                          int C, int d, int k, int lists, cudaStream_t stream) {
  return gathered<int8_t, Src::kSlab>(q, emb, scl, cand, partial, scores, ids, B, 0, C, d, k,
                                      lists, stream);
}
