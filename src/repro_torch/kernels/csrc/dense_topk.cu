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
// running top-k in VMEM from one grid step to the next. Here:
//  1. scan_kernel: a persistent grid, one CTA per SM (the caller passes the
//     count, `lists`) times ceil(B / QB) query blocks. CTA x walks the row
//     tiles x, x + lists, ... of kTileRows rows; each tile is scored in steps
//     of kDC columns of d. A ring of 4-8 steps in shared memory (as deep as
//     fits) is fed by cp.async 16-byte copies (the KB chunk as stored: fp32,
//     or raw int8 codes, cast as they are read; beside it the queries'
//     chunk), so device memory stays busy while the CTA scores and selects.
//     Each thread owns RM rows x QN queries of the tile and reads them as
//     16-byte vectors: RM + QN loads per 4*RM*QN FMAs. Query blocks: QB = 1,
//     4, 16 (2 x 8 per thread) and 64 (4 x 8 per thread, 512 threads, for
//     17 <= B and k <= 32, so the KB is read once for every B <= 64). Every
//     score is one thread's fmaf chain over d in order from 0.0f, so a
//     query's scores do not depend on B, its block or the split; int8 rows:
//     the row's scale multiplies the finished score.
//     Selection is by threshold (Block/WarpSelect in Johnson et al.,
//     "Billion-scale similarity search with GPUs"): per query the CTA keeps a
//     list of `cap` keys in shared memory and the key of its k-th best; a
//     scored row whose key does not beat it is dropped in registers, others
//     are appended (one shared atomic per warp and query). A full list is
//     sorted by one warp (bitonic) down to its best k, which raises the
//     threshold. The first tile seeds the threshold from warp-wide k-th
//     maxima and is cut to k at once. Keys are unique (the id is in the
//     key), so the set kept does not depend on the order rows arrive in.
//     Each CTA writes one list of k keys per query. Its cost grows with k:
//     on an H100 the scan takes 0.69 ms at B = 12, k = 1 and 0.77 ms at
//     k = 20 (PERF.md).
//  2. launch_merge (topk_common.cuh) over the `lists` lists per query: one
//     level at k <= 31 with 4096-key merge CTAs.
// A key is (order-preserving bits of the score) << 32 | ~id, so one unsigned
// comparison gives score descending, then id ascending; an empty slot is 0,
// below every real key (the caller guarantees k <= N, so none is returned).
#include "cp_async.cuh"
#include "topk_common.cuh"

namespace {

constexpr int kTileRows = 256;       // KB rows per tile (every configuration)
constexpr int kSmemMax = 232448;     // dynamic shared memory a CTA may use (227 KB)
constexpr int kScanMergeBuf = 4096;  // keys a merge CTA sorts
constexpr int kWideMaxK = 32;        // largest k for 64-query blocks (list size)

// Per-query list size: a power of two, at least 64 and 2k.
int list_cap(int k) {
  int c = 64;
  while (c < 2 * k) c <<= 1;
  return c;
}

template <int QB, int QN, int RM, int THREADS, typename T>
struct Cfg {
  static constexpr bool kInt8 = sizeof(T) == 1;
  static constexpr int kNQG = QB / QN;                  // query groups
  static constexpr int kNRG = THREADS / kNQG;           // row groups
  static_assert(kNRG * RM == kTileRows, "a tile is kTileRows rows");
  static constexpr int kDC = kInt8 ? 64 : 32;           // elements of d per step
  static constexpr int kVec = 16 / sizeof(T);           // elements per 16-byte copy
  static constexpr int kRowBytes = kDC * sizeof(T) + 16;  // staged row pitch:
  // 16-byte reads of 8 consecutive rows hit 8 distinct bank quads
  static constexpr int kQPitch = kDC + 4;               // staged query pitch (floats)
  static constexpr int kStageBytes = kTileRows * kRowBytes + QB * kQPitch * 4;
  static constexpr int kMaxCap = QB > 16 ? 2 * kWideMaxK : 512;
  static constexpr int kListBytes = QB * kMaxCap * 8 + QB * 12;  // lists, thresholds, counts
  // the deepest ring that fits beside the largest lists, up to 8 steps
  static constexpr int kStages = (kSmemMax - kListBytes) / kStageBytes < 8
                                     ? (kSmemMax - kListBytes) / kStageBytes : 8;
  static_assert(kStages >= 3, "the copy ring needs three stages");
  static constexpr size_t smem(int cap) {
    return static_cast<size_t>(kStages) * kStageBytes + static_cast<size_t>(QB) * cap * 8 +
           QB * 12;
  }
};

// Four int8 codes (one 32-bit word) -> exact floats without I2F, which runs
// at a quarter of the FMA rate: with the sign bit flipped, byte b is x + 128,
// and 2^23 + b is the float whose low mantissa byte is b.
__device__ __forceinline__ void cast4(uint32_t word, float* x) {
  const uint32_t u = word ^ 0x80808080u;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    x[e] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7650 + e)) - 8388736.0f;
}

// Sort one query's list (cap keys, a power of two; empty slots 0) descending
// with one warp, keep the best k, and raise the threshold to the k-th key
// once k keys are held.
__device__ void flush_list(uint64_t* list, int cap, int k, int* cnt, uint64_t* thr,
                           int lane) {
  for (int size = 2; size <= cap; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = lane; i < cap / 2; i += 32) {
        const int a = i + (i & -stride);     // 2*stride*(i/stride) + i%stride
        const bool desc = (a & size) == 0;
        const uint64_t x = list[a], y = list[a + stride];
        if ((x < y) == desc) { list[a] = y; list[a + stride] = x; }
      }
      __syncwarp();
    }
  }
  const int keep = min(min(*cnt, cap), k);
  for (int i = keep + lane; i < cap; i += 32) list[i] = 0ull;
  __syncwarp();
  if (lane == 0) {
    *cnt = keep;
    if (keep == k && list[k - 1] > *thr) *thr = list[k - 1];
  }
  __syncwarp();
}

// The k-th largest (1 <= k <= 32) of the warp's 32 values: a bitonic sort
// across the lanes, descending, then lane k - 1's value.
__device__ uint64_t warp_kth(uint64_t v, int k, int lane) {
  for (int size = 2; size <= 32; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const uint64_t o = __shfl_xor_sync(0xffffffffu, static_cast<unsigned long long>(v), stride);
      const bool keep_max = ((lane & size) == 0) == ((lane & stride) == 0);
      v = keep_max == (v > o) ? v : o;
    }
  }
  return __shfl_sync(0xffffffffu, static_cast<unsigned long long>(v), k - 1);
}

template <int QB, int QN, int RM, int THREADS, typename T>
__global__ void __launch_bounds__(THREADS, 1)
scan_kernel(const float* __restrict__ q, const T* __restrict__ kb,
            const float* __restrict__ scales, uint64_t* __restrict__ partial,
            int B, int N, int d, int k, int cap) {
  using C = Cfg<QB, QN, RM, THREADS, T>;
  constexpr int kStages = C::kStages;
  constexpr int kWarps = THREADS / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* lists = reinterpret_cast<uint64_t*>(smem + kStages * C::kStageBytes);  // [QB][cap]
  uint64_t* thr = lists + QB * cap;                                                // [QB]
  int* cnt = reinterpret_cast<int*>(thr + QB);                                     // [QB]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = tid % C::kNRG, qg = tid / C::kNRG;
  const int q0 = blockIdx.y * QB;
  const int nchunk = (d + C::kDC - 1) / C::kDC;
  const int ntiles = (N + kTileRows - 1) / kTileRows;
  const int my_tiles = static_cast<int>(blockIdx.x) < ntiles
                           ? (ntiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1 : 0;
  const int steps = my_tiles * nchunk;
  auto tile_row0 = [&](int step) {
    return (static_cast<int>(blockIdx.x) + (step / nchunk) * static_cast<int>(gridDim.x)) *
           kTileRows;
  };

  for (int x = tid; x < QB * cap; x += THREADS) lists[x] = 0ull;
  for (int j = tid; j < QB; j += THREADS) { thr[j] = 0ull; cnt[j] = 0; }

  // one step: the tile's rows x kDC columns of d, and the queries' kDC columns
  auto issue = [&](int step) {
    if (step < steps) {
      unsigned char* st = smem + (step % kStages) * C::kStageBytes;
      const int row0 = tile_row0(step), c0 = (step % nchunk) * C::kDC;
      constexpr int kPieces = C::kDC / C::kVec;        // 16-byte copies per staged row
      for (int f = tid; f < kTileRows * kPieces; f += THREADS) {
        const int r = f / kPieces, p = f % kPieces;
        const int grow = row0 + r, gcol = c0 + p * C::kVec;
        const bool ok = grow < N && gcol < d;
        cp_async16(st + r * C::kRowBytes + p * 16,
                   ok ? kb + static_cast<size_t>(grow) * d + gcol : kb, ok ? 16 : 0);
      }
      float* qs = reinterpret_cast<float*>(st + kTileRows * C::kRowBytes);
      for (int f = tid; f < QB * (C::kDC / 4); f += THREADS) {
        const int j = f / (C::kDC / 4), p = f % (C::kDC / 4);
        const int gq = q0 + j, gcol = c0 + p * 4;
        const bool ok = gq < B && gcol < d;
        cp_async16(qs + j * C::kQPitch + p * 4,
                   ok ? q + static_cast<size_t>(gq) * d + gcol : q, ok ? 16 : 0);
      }
    }
    cp_async_commit();                 // empty groups too: the wait count stays uniform
  };

  float acc[RM][QN];
  float sc[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    sc[i] = 1.0f;
#pragma unroll
    for (int j = 0; j < QN; ++j) acc[i][j] = 0.0f;
  }
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();      // this step's copies have landed ...
    __syncthreads();                   // ... for every thread, and step - 1 is consumed
    issue(step + kStages - 1);
    const int chunk = step % nchunk;
    const int row0 = tile_row0(step);
    if constexpr (C::kInt8) {
      if (chunk == 0) {                // the rows' scales, needed when the tile ends
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const int row = row0 + rg + C::kNRG * i;
          sc[i] = row < N ? __ldg(scales + row) : 0.0f;
        }
      }
    }
    const unsigned char* st = smem + (step % kStages) * C::kStageBytes;
    const float* qs = reinterpret_cast<const float*>(st + kTileRows * C::kRowBytes) +
                      qg * QN * C::kQPitch;
    // kVec columns of d for the thread's rows and queries, each acc in d order
    auto score = [&](int c) {
      if constexpr (!C::kInt8) {
        float4 x[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i)
          x[i] = *reinterpret_cast<const float4*>(st + (rg + C::kNRG * i) * C::kRowBytes + c * 4);
#pragma unroll
        for (int j = 0; j < QN; ++j) {
          const float4 w = *reinterpret_cast<const float4*>(qs + j * C::kQPitch + c);
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            acc[i][j] = fmaf(w.x, x[i].x, acc[i][j]);
            acc[i][j] = fmaf(w.y, x[i].y, acc[i][j]);
            acc[i][j] = fmaf(w.z, x[i].z, acc[i][j]);
            acc[i][j] = fmaf(w.w, x[i].w, acc[i][j]);
          }
        }
      } else {
        uint4 raw[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i)
          raw[i] = *reinterpret_cast<const uint4*>(st + (rg + C::kNRG * i) * C::kRowBytes + c);
#pragma unroll
        for (int w4 = 0; w4 < 4; ++w4) {
          float x[RM][4];
#pragma unroll
          for (int i = 0; i < RM; ++i)
            cast4(w4 == 0 ? raw[i].x : w4 == 1 ? raw[i].y : w4 == 2 ? raw[i].z : raw[i].w, x[i]);
#pragma unroll
          for (int j = 0; j < QN; ++j) {
            const float4 w = *reinterpret_cast<const float4*>(qs + j * C::kQPitch + c + 4 * w4);
#pragma unroll
            for (int i = 0; i < RM; ++i) {
              acc[i][j] = fmaf(w.x, x[i][0], acc[i][j]);
              acc[i][j] = fmaf(w.y, x[i][1], acc[i][j]);
              acc[i][j] = fmaf(w.z, x[i][2], acc[i][j]);
              acc[i][j] = fmaf(w.w, x[i][3], acc[i][j]);
            }
          }
        }
      }
    };
    constexpr int kStep = C::kInt8 ? 16 : 4;
    const int cmax = min(C::kDC, d - chunk * C::kDC);   // a multiple of kVec
    if (cmax == C::kDC) {              // a whole chunk: unrolled without a branch
#pragma unroll
      for (int c = 0; c < C::kDC; c += kStep) score(c);
    } else {                           // the last, partial chunk of d
      for (int c = 0; c < cmax; c += kStep) score(c);
    }
    if (chunk != nchunk - 1) continue;

    // the tile is scored: drop what cannot beat a query's k-th best, append
    // the rest, and cut full lists down to k (raising the threshold)
    auto key_of = [&](int i, int j) {
      return make_key(C::kInt8 ? acc[i][j] * sc[i] : acc[i][j], row0 + rg + C::kNRG * i);
    };
    const bool first_tile = step < nchunk;
    if (first_tile && k <= 32) {
      // no threshold yet: seed one from the tile itself, so that its rows do
      // not all go through the lists. Per query, the k-th largest of the
      // warp's 32 lane maxima has k keys at or above it, so a key below it
      // cannot be in the top k.
#pragma unroll
      for (int j = 0; j < QN; ++j) {
        uint64_t best = 0ull;
#pragma unroll
        for (int i = 0; i < RM; ++i)
          if (row0 + rg + C::kNRG * i < N && q0 + qg * QN + j < B) {
            const uint64_t key = key_of(i, j);
            if (key > best) best = key;
          }
        const uint64_t kth = warp_kth(best, k, lane);
        if (lane == 0 && kth != 0ull)
          atomicMax(reinterpret_cast<unsigned long long*>(thr + qg * QN + j),
                    static_cast<unsigned long long>(kth - 1));
      }
      __syncthreads();
    }
    uint64_t pending = 0;            // bit i * QN + j: row i, query j still to place
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
      for (int j = 0; j < QN; ++j) {
        const int jj = qg * QN + j;
        if (row0 + rg + C::kNRG * i < N && q0 + jj < B && key_of(i, j) > thr[jj])
          pending |= 1ull << (i * QN + j);
      }
    }
    while (__syncthreads_or(pending != 0)) {
#pragma unroll
      for (int i = 0; i < RM; ++i) {
#pragma unroll
        for (int j = 0; j < QN; ++j) {
          // jj is the same across the warp (a warp holds one query group):
          // one atomic per warp reserves the slots of all its lanes' keys
          const uint64_t bit = 1ull << (i * QN + j);
          const int jj = qg * QN + j;
          const uint64_t key = key_of(i, j);
          if ((pending & bit) && key <= thr[jj]) pending &= ~bit;   // the threshold rose
          const unsigned want = __ballot_sync(0xffffffffu, (pending & bit) != 0);
          if (want) {
            const int leader = __ffs(want) - 1;
            int base = 0;
            if (lane == leader) base = atomicAdd(&cnt[jj], __popc(want));
            base = __shfl_sync(0xffffffffu, base, leader);
            const int pos = base + __popc(want & ((1u << lane) - 1u));
            if ((pending & bit) && pos < cap) { lists[jj * cap + pos] = key; pending &= ~bit; }
          }
        }
      }
      __syncthreads();
      for (int jj = warp; jj < QB; jj += kWarps)
        if (cnt[jj] >= cap || (first_tile && cnt[jj] > k))   // after the first tile the
          flush_list(lists + jj * cap, cap, k, cnt + jj, thr + jj, lane);   // threshold is exact
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < QN; ++j) acc[i][j] = 0.0f;
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int jj = warp; jj < QB; jj += kWarps)
    if (cnt[jj] > k) flush_list(lists + jj * cap, cap, k, cnt + jj, thr + jj, lane);
  __syncthreads();
  for (int f = tid; f < QB * k; f += THREADS) {
    const int jj = f / k, i = f - jj * k;
    if (q0 + jj < B)
      partial[(static_cast<size_t>(q0 + jj) * gridDim.x + blockIdx.x) * k + i] =
          lists[jj * cap + i];
  }
}

template <int QB, int QN, int RM, int THREADS, typename T>
void launch_scan(const float* q, const T* kb, const float* scales, uint64_t* partial,
                 int B, int N, int d, int k, int lists, cudaStream_t stream) {
  using C = Cfg<QB, QN, RM, THREADS, T>;
  auto kernel = scan_kernel<QB, QN, RM, THREADS, T>;
  // once per instantiation, at its largest list size (not per launch: a
  // launch inside CUDA-graph capture makes no other runtime call)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::smem(C::kMaxCap)));
  (void)attr;
  const int cap = list_cap(k);
  dim3 grid(lists, (B + QB - 1) / QB);
  scan_kernel<QB, QN, RM, THREADS, T><<<grid, THREADS, C::smem(cap), stream>>>(
      q, kb, scales, partial, B, N, d, k, cap);
}

template <typename T>
int scan(const float* q, const T* kb, const float* scales, uint64_t* partial,
         float* scores, int* ids, int B, int N, int d, int k, int lists, cudaStream_t stream) {
  if (B == 1)
    launch_scan<1, 1, 1, 256>(q, kb, scales, partial, B, N, d, k, lists, stream);
  else if (B <= 4)
    launch_scan<4, 4, 1, 256>(q, kb, scales, partial, B, N, d, k, lists, stream);
  else if (B <= 16 || k > kWideMaxK)
    launch_scan<16, 8, 2, 256>(q, kb, scales, partial, B, N, d, k, lists, stream);
  else
    launch_scan<64, 8, 4, 512>(q, kb, scales, partial, B, N, d, k, lists, stream);
  launch_merge<kScanMergeBuf>(partial, scores, ids, B, lists, k, nullptr, 0, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, d) f32, kb (N, d) f32, partial u64 scratch of B * k * (n + ceil(n / 8))
// keys with n = lists, the scan's CTAs per query block (one partial list
// each; 1 <= lists, and lists <= ceil(N / 256) so that none is idle) ->
// scores (B, k) f32, ids (B, k) i32. The caller guarantees 1 <= k <=
// min(N, 256) and d % 4 == 0.
extern "C" int dense_topk_launch(const float* q, const float* kb, uint64_t* partial,
                                 float* scores, int* ids, int B, int N, int d, int k,
                                 int lists, cudaStream_t stream) {
  return scan<float>(q, kb, nullptr, partial, scores, ids, B, N, d, k, lists, stream);
}

// B6: the same scan over int8 codes (N, d) with fp32 row scales (N,): the
// score is (q . float(code)) * scale. The caller guarantees d % 16 == 0.
extern "C" int quant_topk_launch(const float* q, const int8_t* codes, const float* scales,
                                 uint64_t* partial, float* scores, int* ids, int B, int N,
                                 int d, int k, int lists, cudaStream_t stream) {
  return scan<int8_t>(q, codes, scales, partial, scores, ids, B, N, d, k, lists, stream);
}
