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
// Design: scan.cuh's scan over the KB's rows (column == id), one CTA per SM
// (the caller passes the count, `lists`) per query block of 1, 4, 16 or 64
// queries, then (k <= 256) one merge level at k <= 31 (topk_common.cuh),
// or (k > 256) the key pass and the select pass. On an H100 a call takes
// 0.66 ms at B = 12, k = 1 and 0.75 ms at k = 20 (PERF.md).
#include "scan.cuh"

namespace {

template <typename T>
int full_scan(const float* q, const T* kb, const float* scales, uint64_t* partial,
              float* scores, int* ids, int B, int N, int d, int k, int lists,
              cudaStream_t stream) {
  constexpr Src D = Src::kDense;
  if (k > kMaxK) {                     // every row's key, then the select pass
    if (B == 1)
      launch_scan<1, 1, 1, 256, T, D, true>(q, kb, scales, nullptr, partial, B, N, N, d, k,
                                            lists, stream);
    else if (B <= 4)
      launch_scan<4, 4, 1, 256, T, D, true>(q, kb, scales, nullptr, partial, B, N, N, d, k,
                                            lists, stream);
    else
      launch_scan<16, 8, 2, 256, T, D, true>(q, kb, scales, nullptr, partial, B, N, N, d, k,
                                             lists, stream);
    launch_select(partial, partial + static_cast<size_t>(B) * N, scores, ids, B, N, k,
                  nullptr, 0, stream);
    return static_cast<int>(cudaGetLastError());
  }
  if (B == 1)
    launch_scan<1, 1, 1, 256, T, D, false>(q, kb, scales, nullptr, partial, B, N, N, d, k,
                                           lists, stream);
  else if (B <= 4)
    launch_scan<4, 4, 1, 256, T, D, false>(q, kb, scales, nullptr, partial, B, N, N, d, k,
                                           lists, stream);
  else if (B <= 16 || k > kWideMaxK)
    launch_scan<16, 8, 2, 256, T, D, false>(q, kb, scales, nullptr, partial, B, N, N, d, k,
                                            lists, stream);
  else
    launch_scan<64, 8, 4, 512, T, D, false>(q, kb, scales, nullptr, partial, B, N, N, d, k,
                                            lists, stream);
  launch_merge(partial, scores, ids, B, lists, k, nullptr, 0, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, d) f32, kb (N, d) f32 -> scores (B, k) f32, ids (B, k) i32, with
// 1 <= k <= N, d % 4 == 0 and lists the scan's CTAs per query block (1 <=
// lists <= ceil(N / 256), so that none is idle). partial is u64 scratch of
// B * k * (lists + ceil(lists / 8)) keys for k <= 256; for k > 256, B * N
// keys, plus B * P with P = k rounded up to a power of two when P > 16384
// (dense_topk.py's scan_scratch).
extern "C" int dense_topk_launch(const float* q, const float* kb, uint64_t* partial,
                                 float* scores, int* ids, int B, int N, int d, int k,
                                 int lists, cudaStream_t stream) {
  return full_scan<float>(q, kb, nullptr, partial, scores, ids, B, N, d, k, lists, stream);
}

// B6: the same scan over int8 codes (N, d) with fp32 row scales (N,): the
// score is (q . float(code)) * scale. The caller guarantees d % 16 == 0.
extern "C" int quant_topk_launch(const float* q, const int8_t* codes, const float* scales,
                                 uint64_t* partial, float* scores, int* ids, int B, int N,
                                 int d, int k, int lists, cudaStream_t stream) {
  return full_scan<int8_t>(q, codes, scales, partial, scores, ids, B, N, d, k, lists, stream);
}
